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
// one-hot matrix with a triangular matmul.  CUDA blocks run in no order, so
// the carry becomes three integer passes over chunks of 256 events, with no
// float one-hot and no matmul:
//   1. moe_dispatch_count: one block per chunk counts its events per expert
//      in a shared-memory histogram (integer counts do not depend on the
//      order of the shared atomics) and writes the chunk's row of the
//      (chunks, E) count table;
//   2. moe_dispatch_scan: one thread per expert turns its column of the
//      table, in place, into the exclusive prefix over chunks; the column's
//      total is `load`;
//   3. moe_dispatch_rank: one block per chunk, one thread per event: the
//      rank among earlier events of the same expert in the chunk is
//      __match_any_sync + __popc over the lower lanes of its warp, plus a
//      count over the ids of the chunk's earlier warps (in shared memory,
//      read as broadcasts); adding the chunk's prefix gives the position.
// Nothing waits on another block, and every sum is an integer sum, so the
// result is the same on every run.
//
// Bound.  Bytes: the ids in and the positions out, 4 bytes each, plus the
// (E,) loads: 8 M + 4 E bytes.  At the served prefill stream (4 requests x
// 128 tokens x top-6, M = 3072, E = 64) that is 24,832 bytes, 0.0074 us at
// 3.35 TB/s, so the op is bound by its three launches, not by the card.
// The count table (chunks x E int32, written once and read twice) is
// scratch the wrapper allocates.
//
// Interface: a plain C entry point (loaded with ctypes by
// repro_torch/kernels/moe_dispatch/kernel.py); it launches on the given
// stream, does not synchronise, allocates nothing and returns the
// cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 256;          // events per chunk, one thread each
constexpr int kScanThreads = 128;
constexpr int kScanBatch = 8;        // loads in flight per scan step

__global__ void __launch_bounds__(kChunk)
moe_dispatch_count(const int32_t* __restrict__ ids, int64_t m, int e,
                   int32_t* __restrict__ counts) {
  extern __shared__ int32_t hist[];  // e ints
  for (int x = threadIdx.x; x < e; x += kChunk) hist[x] = 0;
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * kChunk + threadIdx.x;
  if (i < m) {
    const int32_t id = ids[i];
    if (id >= 0 && id < e) atomicAdd(&hist[id], 1);
  }
  __syncthreads();
  int32_t* row = counts + (int64_t)blockIdx.x * e;
  for (int x = threadIdx.x; x < e; x += kChunk) row[x] = hist[x];
}

__global__ void __launch_bounds__(kScanThreads)
moe_dispatch_scan(int32_t* __restrict__ counts, int64_t chunks, int e,
                  int32_t* __restrict__ load) {
  const int x = blockIdx.x * kScanThreads + threadIdx.x;
  if (x >= e) return;
  int32_t* col = counts + x;
  int32_t run = 0;
  int64_t c = 0;
  for (; c + kScanBatch <= chunks; c += kScanBatch) {
    int32_t n[kScanBatch];
#pragma unroll
    for (int k = 0; k < kScanBatch; ++k) n[k] = col[(c + k) * e];
#pragma unroll
    for (int k = 0; k < kScanBatch; ++k) {
      col[(c + k) * e] = run;
      run += n[k];
    }
  }
  for (; c < chunks; ++c) {
    const int32_t n = col[c * e];
    col[c * e] = run;
    run += n;
  }
  load[x] = run;
}

__global__ void __launch_bounds__(kChunk)
moe_dispatch_rank(const int32_t* __restrict__ ids, int64_t m, int e,
                  const int32_t* __restrict__ offsets,
                  int32_t* __restrict__ pos) {
  __shared__ __align__(16) int32_t chunk_ids[kChunk];
  const int t = threadIdx.x;
  const int64_t i = (int64_t)blockIdx.x * kChunk + t;
  const int32_t id = i < m ? ids[i] : -1;
  chunk_ids[t] = id;
  __syncthreads();
  // earlier warps of the chunk: the same trip count for the whole warp
  const int warp_base = t & ~31;
  const int4* earlier = reinterpret_cast<const int4*>(chunk_ids);
  int32_t rank = 0;
  for (int j = 0; j < warp_base / 4; ++j) {
    const int4 q = earlier[j];
    rank += (q.x == id) + (q.y == id) + (q.z == id) + (q.w == id);
  }
  // lower lanes of this warp; every lane takes part in the match
  const unsigned same = __match_any_sync(0xffffffffu, id);
  rank += __popc(same & ((1u << (t & 31)) - 1u));
  if (i < m)
    pos[i] = (id >= 0 && id < e)
                 ? offsets[(int64_t)blockIdx.x * e + id] + rank : 0;
}

}  // namespace

extern "C" {

// m int32 expert ids -> pos (m int32) and load (e int32); scratch holds
// ceil(m / 256) * e int32.  m >= 1 and 1 <= e <= 58112, the largest E
// whose histogram fits a block's shared memory (227 KB).
int moe_dispatch_launch(const int32_t* ids, int64_t m, int e,
                        int32_t* scratch, int32_t* pos, int32_t* load,
                        void* cuda_stream) {
  const cudaStream_t stream = static_cast<cudaStream_t>(cuda_stream);
  const int64_t chunks = (m + kChunk - 1) / kChunk;
  const size_t hist_bytes = (size_t)e * sizeof(int32_t);
  if (hist_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_dispatch_count, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)hist_bytes);
    if (err != cudaSuccess) return err;
  }
  moe_dispatch_count<<<(unsigned)chunks, kChunk, hist_bytes, stream>>>(
      ids, m, e, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_dispatch_scan<<<(e + kScanThreads - 1) / kScanThreads, kScanThreads, 0,
                      stream>>>(scratch, chunks, e, load);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_dispatch_rank<<<(unsigned)chunks, kChunk, 0, stream>>>(
      ids, m, e, scratch, pos);
  return cudaGetLastError();
}

}  // extern "C"
