// Hierarchical address-event encoding for Hopper (sm_90a).
//
// Replaces the TPU kernel `hat_encode_pallas` (src/repro/kernels/hat_encode/
// kernel.py:50, body `_hat_encode_kernel`).  From a spike bitmap (N,) it
// computes the service rank of every neuron (inclusive prefix count - 1 in
// ascending address order, -1 where silent), the event count of every
// cluster of `row` consecutive neurons, and the total; in the same pass it
// writes the AER stream `compact_stream` makes of the ranks:
// stream[rank[i]] = i, padded with N after the last event.
//
// Design.  The TPU kernel scans with two triangular f32 matmuls, an idiom of
// its matrix unit.  Here the scan is integer and exact by construction: one
// block per bitmap (the interface tick launches once for all lanes x cores),
// 256 threads over chunks of 256 neurons.  Within a warp, __ballot_sync gives
// the chunk's spike mask and __popc of its lower lanes each neuron's prefix;
// warp 0 scans the eight warp totals with shuffles; a carry takes the count
// from one chunk to the next, so any N up to 2^16 (the JAX bound) is one
// block.  A cluster's count is the inclusive prefix at its last neuron less
// the exclusive prefix at its first: the first neuron's thread stores that
// prefix in the output, and after a barrier the last neuron's thread turns it
// into the count.
//
// Bound.  On the interface path (16 cores x 256 neurons a lane) the kernel
// moves some 37 KB a tick: it is bound by its launch, not by bytes or
// operations.
//
// Interface: a plain C entry point (loaded with ctypes by
// repro_torch/kernels/hat_encode/kernel.py); it launches on the given stream,
// does not synchronise, allocates nothing and returns the cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
hat_encode_kernel(const uint8_t* __restrict__ spikes, int32_t* ranks,
                  int32_t* clusters, int32_t* totals, int32_t* stream, int N,
                  int row) {
  __shared__ int32_t warp_total[kWarps];
  __shared__ int32_t warp_offset[kWarps];
  const int r = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const uint8_t* s_row = spikes + (size_t)r * N;
  int32_t* rank_row = ranks + (size_t)r * N;
  int32_t* cluster_row = clusters + (size_t)r * (N / row);
  int32_t* stream_row = stream ? stream + (size_t)r * N : nullptr;

  int carry = 0;                           // events before this chunk
  for (int c0 = 0; c0 < N; c0 += kThreads) {
    const int i = c0 + threadIdx.x;
    const bool in = i < N;
    const bool s = in && s_row[i] != 0;
    const unsigned mask = __ballot_sync(kFull, s);
    if (lane == 0) warp_total[warp] = __popc(mask);
    __syncthreads();
    if (warp == 0) {                       // exclusive scan of warp totals
      const int v = lane < kWarps ? warp_total[lane] : 0;
      int incl = v;
      for (int o = 1; o < kWarps; o <<= 1) {
        const int up = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += up;
      }
      if (lane < kWarps) warp_offset[lane] = incl - v;
    }
    __syncthreads();
    const int excl = carry + warp_offset[warp] + __popc(mask & lower);
    if (in) {
      rank_row[i] = s ? excl : -1;
      if (s && stream_row) stream_row[excl] = i;
      if (i % row == 0) cluster_row[i / row] = excl;
    }
    __syncthreads();                       // cluster starts are stored
    if (in && (i + 1) % row == 0)
      cluster_row[i / row] = excl + (int)s - cluster_row[i / row];
    carry += warp_offset[kWarps - 1] + warp_total[kWarps - 1];
    __syncthreads();                       // shared totals are read
  }
  if (threadIdx.x == 0) totals[r] = carry;
  if (stream_row)
    for (int j = carry + threadIdx.x; j < N; j += kThreads) stream_row[j] = N;
}

}  // namespace

extern "C" {

// (R, N) bool bitmaps -> ranks (R, N) int32, cluster counts (R, N / row)
// int32, totals (R,) int32 and, when `stream` is not null, AER streams
// (R, N) int32.  N % row == 0.
int hat_encode_launch(const uint8_t* spikes, int32_t* ranks,
                      int32_t* clusters, int32_t* totals, int32_t* stream,
                      int R, int N, int row, void* cuda_stream) {
  hat_encode_kernel<<<R, kThreads, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      spikes, ranks, clusters, totals, stream, N, row);
  return cudaGetLastError();
}

}  // extern "C"
