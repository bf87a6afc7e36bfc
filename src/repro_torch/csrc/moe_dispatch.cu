// Capacity-ordered MoE dispatch positions for Hopper (sm_90a).
//
// Replaces the TPU kernel `dispatch_positions_pallas` (src/repro/kernels/
// moe_dispatch/kernel.py:83, body `_dispatch_kernel`).  For an (M,) int32
// stream of expert ids in arbitration order it writes
//   pos[i]  = the number of earlier events with the same expert
//             (the arrival-order position that decides capacity drops),
//   load[e] = the number of events of expert e,
// without a sort.  An id outside [0, E) gets position 0 and is not counted
// in `load`, as the TPU kernel's `in_tile` mask has it (kernel.py:48-50):
// the MoE router pads its stream with the id E.
//
// Design.  The TPU kernel walks a (expert tiles, rows of 256 events) grid
// and carries running per-expert totals across rows in VMEM, which works
// only because a TPU grid runs in order; inside a row it scans a float
// one-hot matrix with a triangular matmul.  Here one launch does it all, in
// integers, with no scratch in device memory.  A block of 1024 threads walks
// its span of events in order, a round of 1024 events (one a thread) at a
// time, carrying per-expert running totals in shared memory (the loop takes
// the place of the TPU grid's sequential carry).  In a round:
//   - each event ORs its lane's bit into a (warp, expert) word of a shared
//     table: the word is then the mask of its warp's events of that expert
//     (an OR, so the atomics' order does not matter), and __popc of the
//     lower lanes is the event's rank in its warp;
//   - the lowest such lane writes the group's size over the word; one
//     thread per expert walks the 32 warps' sizes in warp order (event
//     order), writing each warp's exclusive prefix from the running total;
//   - an event's position is its warp's prefix plus its rank.
// The served streams (decode: 256 ids, prefill: 3072) are one block and no
// cluster.  A longer stream (more than four rounds) is one thread block
// cluster of G blocks (G <= 8, chosen from M by the wrapper), block r
// taking the r-th contiguous span: each block first counts its span per
// expert with shared atomics, and after cluster.sync() reads the histograms
// of blocks 0..r-1 through distributed shared memory, in rank order, as the
// start of its running totals (block order is event order).  The last
// block's final totals are `load`.  Every sum is an integer sum and every
// barrier is reached by all its threads, so the result is the same on every
// run and nothing can hang; a cluster the card cannot place fails the
// launch, and the wrapper raises.
//
// What the design does about the card.  The first port spent three launches
// (count, scan, rank) on a few kilobytes, and a (chunks, E) table in device
// memory.  Within one block on one SM, warp-wide collectives are what cost:
// a cluster barrier, __match_any_sync (or a ballot per key bit) and a
// shuffle scan over the warps each take a large share of a few-us kernel
// when 32 warps issue them every round; one shared atomic per event and a
// per-expert walk of independent shared loads replace them, and the served
// streams need no cluster.
//
// Bound.  Bytes: the ids in and the positions out, 4 bytes each, plus the
// (E,) loads: 8 M + 4 E bytes.  At the served prefill stream (4 requests x
// 128 tokens x top-6, M = 3072, E = 64) that is 24,832 bytes, 0.0074 us at
// 3.35 TB/s, so the op is bound by its launch and its rounds' barriers, not
// by the card.  Shared memory: (2 + 32) E int32 a block (running totals,
// histogram, table), so E <= 1709.
//
// Interface: a plain C entry point (loaded with ctypes by
// repro_torch/kernels/moe_dispatch/kernel.py); it launches on the given
// stream, does not synchronise, allocates nothing and returns the
// cudaError_t.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;       // events per round, one thread each
constexpr int kWarps = kThreads / 32;
constexpr int kScanBatch = 8;        // counts an expert's thread loads at once
constexpr int kMaxBlocks = 8;        // the largest portable cluster

// Step 3 for one round of 1024 events: their positions, and the running
// totals carried past them.  `table` (kWarps rows of e words) is all zero on
// entry and on exit.  Called by the whole block: it holds two barriers.
__device__ __forceinline__ void rank_round(int32_t id, int64_t i, int64_t hi,
                                           int e, int lane, int warp,
                                           int32_t* run, int32_t* table,
                                           int32_t* __restrict__ pos) {
  const bool in = id >= 0 && id < e;
  int32_t* cell = table + warp * e + (in ? id : 0);
  // the lanes of this warp with this expert: each sets its bit in the
  // (warp, expert) word (an OR, so the order of the atomics does not matter)
  if (in) atomicOr(reinterpret_cast<unsigned*>(cell), 1u << lane);
  __syncwarp();
  const unsigned same = in ? static_cast<unsigned>(*cell) : 0u;
  const unsigned below = same & ((1u << lane) - 1u);
  __syncwarp();
  if (in && below == 0) *cell = __popc(same);   // the group's leader
  __syncthreads();
  // expert x: one thread walks the 32 warps' counts in warp order (event
  // order), kScanBatch independent loads at a time; only the adds chain
  for (int x = threadIdx.x; x < e; x += kThreads) {
    int32_t carry = run[x];
#pragma unroll
    for (int w0 = 0; w0 < kWarps; w0 += kScanBatch) {
      int32_t n[kScanBatch];
#pragma unroll
      for (int w = 0; w < kScanBatch; ++w) n[w] = table[(w0 + w) * e + x];
#pragma unroll
      for (int w = 0; w < kScanBatch; ++w) {
        if (n[w] != 0) table[(w0 + w) * e + x] = carry;
        carry += n[w];
      }
    }
    run[x] = carry;
  }
  __syncthreads();
  const int32_t first = in ? *cell : 0;
  if (i < hi) pos[i] = in ? first + __popc(below) : 0;
  __syncwarp();
  if (in && below == 0) *cell = 0;     // only this warp reads its row
  __syncwarp();                        // before the next round's writes
}

__global__ void __launch_bounds__(kThreads)
moe_dispatch_kernel(const int32_t* __restrict__ ids, int64_t m, int e,
                    int64_t span, int32_t* __restrict__ pos,
                    int32_t* __restrict__ load) {
  extern __shared__ int32_t smem[];
  int32_t* run = smem;                 // e: running totals
  int32_t* hist = smem + e;            // e: this block's events per expert
  int32_t* table = smem + 2 * e;       // kWarps x e: one round's counts
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // one block, as on the served streams: no cluster barrier at all
  const bool clustered = gridDim.x > 1;
  cg::cluster_group cluster = cg::this_cluster();
  const int64_t rank = clustered ? cluster.block_rank() : 0;
  const int64_t lo = rank * span < m ? rank * span : m;
  const int64_t hi = lo + span < m ? lo + span : m;

  int32_t id = lo + threadIdx.x < hi ? ids[lo + threadIdx.x] : -1;
  for (int x = threadIdx.x; x < kWarps * e; x += kThreads) table[x] = 0;
  for (int x = threadIdx.x; x < e; x += kThreads) run[x] = hist[x] = 0;

  if (clustered) {
    // 1. this block's histogram, round by round (the next round's ids are
    // loaded while this one's are counted)
    __syncthreads();
    int32_t now = id;
#pragma unroll 1
    for (int64_t c0 = lo; c0 < hi; c0 += kThreads) {
      const int64_t i = c0 + kThreads + threadIdx.x;
      const int32_t next = i < hi ? ids[i] : -1;
      if (now >= 0 && now < e) atomicAdd(&hist[now], 1);
      now = next;
    }
    // 2. the exclusive prefix over the cluster's earlier blocks
    cluster.sync();
    for (int x = threadIdx.x; x < e; x += kThreads) {
      int32_t before = 0;
      for (int64_t r = 0; r < rank; ++r)
        before += cluster.map_shared_rank(hist, (int)r)[x];
      run[x] = before;
    }
    // done reading the other blocks' histograms; each waits for all at exit
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  }
  __syncthreads();

  // 3. positions, round by round in event order
#pragma unroll 1
  for (int64_t c0 = lo; c0 < hi; c0 += kThreads) {
    const int64_t i = c0 + kThreads + threadIdx.x;
    const int32_t next = i < hi ? ids[i] : -1;
    rank_round(id, c0 + threadIdx.x, hi, e, lane, warp, run, table, pos);
    id = next;
  }
  // the last block's running totals are the loads (the last round's
  // barrier ordered their writes)
  if (rank == gridDim.x - 1) {
    for (int x = threadIdx.x; x < e; x += kThreads) load[x] = run[x];
  }
  if (clustered)
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

}  // namespace

extern "C" {

// m int32 expert ids -> pos (m int32) and load (e int32), in one launch of
// `blocks` (1-8) blocks taking `span` events each, one thread block cluster
// when blocks > 1; the wrapper chooses them (kernels/moe_dispatch/
// kernel.py, launch_geometry).  m >= 1 and 1 <= e <= 1709, the largest E
// whose (2 + 32) e int32 fit a block's shared memory (227 KB).
int moe_dispatch_launch(const int32_t* ids, int64_t m, int e, int blocks,
                        int64_t span, int32_t* pos, int32_t* load,
                        void* cuda_stream) {
  // the spans must cover the stream, in at most a portable cluster
  if (m < 1 || e < 1 || blocks < 1 || blocks > kMaxBlocks || span < 1 ||
      (int64_t)blocks * span < m)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)(2 + kWarps) * e * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_dispatch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(cuda_stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = blocks > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&config, moe_dispatch_kernel,
                                             ids, m, e, span, pos, load);
  if (err != cudaSuccess) {
    cudaGetLastError();                  // clear it; the caller raises
    return err;
  }
  return cudaGetLastError();
}

}  // extern "C"
