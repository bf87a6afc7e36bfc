// Packed-tag CAM search for Hopper (sm_90a).
//
// Replaces the TPU kernel `cam_search_pallas` (src/repro/kernels/cam_search/
// kernel.py:40, body `_cam_search_kernel`): every query row's packed tag words
// against every stored entry's words, ANDed with the entry's valid flag,
//
//   match[b, e] = valid[e] & all_w(q[b, w] == t[e, w]).
//
// Words are int32 as `pack_bits` makes them (bit 31 may be set); `==` on
// int32 compares the 32-bit patterns, which is the JAX compare.
//
// Two entry points over one device routine (`tag_equal`):
//
//   cam_search_launch        writes the (B, E) int32 match matrix, as the TPU
//                            kernel does.  One thread per output element,
//                            consecutive threads on consecutive entries, so
//                            the writes coalesce.  Bound by the B * E * 4
//                            bytes it must write.
//   cam_match_counts_launch  what the interface tick runs: the match counted
//                            over E inside the kernel, for L lanes of valid
//                            flags at once,
//                              counts[l, b] = sum_e valid[l, e] & match(b, e),
//                            so the (B, E) matrix (134 MB at 8192 x 4096)
//                            never reaches device memory.  The TPU path
//                            writes that matrix and sums its rows.
//
// Counts design.  A block is 8 warps over 32 query rows: lane i of every warp
// holds row blockIdx.x * 32 + i and its W words in registers, and warp j takes
// the j-th eighth of each tile of entries, so each SM gets enough warps at
// B = 8192 (256 blocks per lane).  Tiles of tags and of the lane's valid flags
// are staged in shared memory; all lanes of a warp read the same entry at
// once, a broadcast without bank conflicts.  Integer compares and an integer
// count per thread, then the eight partial counts of a row are summed in
// shared memory in a fixed order: no atomics, the same result on every run.
//
// Bound.  The counts are bound by operations: about (2W + 1) integer
// operations per (row, entry) pair and lane (W compares, W ANDs, one add), 1e8
// at 8192 x 4096 x W = 1, about 3 us at the H100's int32 rate; the bytes
// (tags, flags and counts, 84 KB) are negligible.
//
// Interface: plain C entry points (loaded with ctypes by
// repro_torch/kernels/cam_search/kernel.py); they launch on the given stream,
// do not synchronise, allocate nothing and return the cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kRows = 32;          // query rows per counts block (one a lane)
constexpr int kSlices = 8;         // warps per counts block, one per E slice
constexpr int kTileWords = 4096;   // int32 tag words staged per tile (16 KB)

// All W words of a query equal an entry's?  kW > 0 fixes W at compile time
// (q held in registers); kW == 0 reads a runtime W.
template <int kW>
__device__ __forceinline__ bool tag_equal(const int32_t* q, const int32_t* t,
                                          int w_rt) {
  const int w_n = kW > 0 ? kW : w_rt;
  bool eq = true;
#pragma unroll
  for (int w = 0; w < (kW > 0 ? kW : 1); ++w) eq &= (q[w] == t[w]);
  if (kW == 0) {
    for (int w = 1; w < w_n; ++w) eq &= (q[w] == t[w]);
  }
  return eq;
}

template <int kW>
__global__ void __launch_bounds__(256)
cam_search_kernel(const int32_t* __restrict__ q, const int32_t* __restrict__ t,
                  const uint8_t* __restrict__ valid, int32_t* __restrict__ out,
                  int B, int E, int W) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y * blockDim.y + threadIdx.y;
  if (b >= B || e >= E) return;
  const int w_n = kW > 0 ? kW : W;
  const bool hit = valid[e] &&
      tag_equal<kW>(q + (size_t)b * w_n, t + (size_t)e * w_n, W);
  out[(size_t)b * E + e] = hit ? 1 : 0;
}

template <int kW>
__global__ void __launch_bounds__(kRows * kSlices)
cam_match_counts_kernel(const int32_t* __restrict__ q,
                        const int32_t* __restrict__ t,
                        const uint8_t* __restrict__ valid,
                        int32_t* __restrict__ counts, int B, int E, int W,
                        int tile) {
  extern __shared__ int32_t smem[];
  int32_t* t_tile = smem;                                  // tile * W words
  uint8_t* v_tile = reinterpret_cast<uint8_t*>(smem + tile * W);
  __shared__ int32_t partial[kSlices][kRows];

  const int lane_id = threadIdx.x & 31;
  const int slice = threadIdx.x >> 5;
  const int row = blockIdx.x * kRows + lane_id;
  const int l = blockIdx.y;
  const uint8_t* v_lane = valid + (size_t)l * E;
  const int w_n = kW > 0 ? kW : W;

  // the row's query words: registers when W is fixed, else read from q
  const int32_t* q_row = q + (size_t)min(row, B - 1) * w_n;
  int32_t q_reg[kW > 0 ? kW : 1];
  if constexpr (kW > 0) {
#pragma unroll
    for (int w = 0; w < kW; ++w) q_reg[w] = q_row[w];
  }

  int count = 0;
  for (int e0 = 0; e0 < E; e0 += tile) {
    const int span = min(tile, E - e0);
    __syncthreads();                       // the previous tile is consumed
    for (int i = threadIdx.x; i < span * w_n; i += blockDim.x)
      t_tile[i] = t[(size_t)e0 * w_n + i];
    for (int i = threadIdx.x; i < span; i += blockDim.x)
      v_tile[i] = v_lane[e0 + i];
    __syncthreads();
    const int per = (span + kSlices - 1) / kSlices;
    const int lo = slice * per;
    const int hi = min(span, lo + per);
#pragma unroll 4
    for (int i = lo; i < hi; ++i)
      count += (v_tile[i] != 0) &
               tag_equal<kW>(kW > 0 ? q_reg : q_row, t_tile + i * w_n, W);
  }
  partial[slice][lane_id] = count;
  __syncthreads();
  if (slice == 0 && row < B) {
    int sum = 0;
#pragma unroll
    for (int s = 0; s < kSlices; ++s) sum += partial[s][lane_id];
    counts[(size_t)l * B + row] = sum;
  }
}

template <int kW>
cudaError_t launch_counts(const int32_t* q, const int32_t* t,
                          const uint8_t* valid, int32_t* counts, int lanes,
                          int B, int E, int W, cudaStream_t stream) {
  const int tile = std::max(1, std::min(E, kTileWords / W));
  // tags, then the valid bytes rounded up to whole int32 words
  const size_t smem = (size_t)tile * W * 4 + (size_t)((tile + 3) / 4) * 4;
  dim3 grid((B + kRows - 1) / kRows, lanes);
  cam_match_counts_kernel<kW><<<grid, kRows * kSlices, smem, stream>>>(
      q, t, valid, counts, B, E, W, tile);
  return cudaGetLastError();
}

template <int kW>
cudaError_t launch_search(const int32_t* q, const int32_t* t,
                          const uint8_t* valid, int32_t* out, int B, int E,
                          int W, cudaStream_t stream) {
  dim3 block(32, 8);
  dim3 grid((E + 31) / 32, (B + 7) / 8);
  cam_search_kernel<kW><<<grid, block, 0, stream>>>(q, t, valid, out, B, E, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// (B, W) int32 queries x (E, W) int32 tags x (E,) bool -> (B, E) int32.
int cam_search_launch(const int32_t* q, const int32_t* t,
                      const uint8_t* valid, int32_t* out, int B, int E, int W,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: return launch_search<1>(q, t, valid, out, B, E, W, s);
    case 2: return launch_search<2>(q, t, valid, out, B, E, W, s);
    case 3: return launch_search<3>(q, t, valid, out, B, E, W, s);
    case 4: return launch_search<4>(q, t, valid, out, B, E, W, s);
    default: return launch_search<0>(q, t, valid, out, B, E, W, s);
  }
}

// (B, W) int32 queries x (E, W) int32 tags x (L, E) bool -> (L, B) int32
// match counts.
int cam_match_counts_launch(const int32_t* q, const int32_t* t,
                            const uint8_t* valid, int32_t* counts, int lanes,
                            int B, int E, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: return launch_counts<1>(q, t, valid, counts, lanes, B, E, W, s);
    case 2: return launch_counts<2>(q, t, valid, counts, lanes, B, E, W, s);
    case 3: return launch_counts<3>(q, t, valid, counts, lanes, B, E, W, s);
    case 4: return launch_counts<4>(q, t, valid, counts, lanes, B, E, W, s);
    default: return launch_counts<0>(q, t, valid, counts, lanes, B, E, W, s);
  }
}

}  // extern "C"
