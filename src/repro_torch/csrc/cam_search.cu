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
// Two entry points:
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
// Counts design.  The match counted over E is an all-pairs compare; on the
// path (B = 8192 CAM entries, E = 4096 sources, W = 1) the valid flags are a
// tick's spike frame, mostly zero.  A source whose flag is zero adds nothing
// to any count, so the kernel compares against the live sources only:
//   - a block of 32 warps takes 64 query rows (128 blocks at the path's
//     B), for one lane of valid flags;
//   - it turns the lane's valid bytes into the list of live tags in shared
//     memory (word-major, W rows of `cap` words): a __ballot_sync per warp
//     and 1024 sources, one barrier, a shuffle scan of the 32 warps' counts
//     for each warp's offset, and a tag load only for a live source.  The
//     list's order does not change a count;
//   - each thread holds R = 2 query rows (rows i and i + 32 of the tile, i
//     its lane), W words each, in registers; warp j takes every 32nd group
//     of four live tags, read as one 16-byte shared load per word (a
//     broadcast: every lane reads the same group), which feeds 4R compares;
//   - a thread counts its matches in float32 registers (whole numbers below
//     2^24 a pass: exact), so the adds issue as predicated FADDs to the FMA
//     pipe beside the compares (ISETP) on the integer pipe, which has 16
//     lanes a partition on this card; an integer count costs a SEL and an
//     IADD on that same pipe as well;
//   - the 32 warps' counts of a row are summed in shared memory in warp
//     order.  No atomics on the counts, no clusters (a cluster barrier
//     costs a large share of a few-us kernel): the same result on every
//     run, and no output needs zeroing first.
// More live sources than `tile` (tile = min(E, 4096 / W)) are staged in
// passes.  W = 1-4 is fixed at compile time; a larger W reads its words at
// run time (q from device memory).  A pass stages at least four tags'
// words beside 8,320 bytes of static shared memory, so W <= 14,008 fits a
// block's 227 KB.
//
// Bound.  The counts are bound by operations: about (2W + 1) integer
// operations per (row, source) pair and lane (W compares, W ANDs, one add).
// Counted over all pairs, 1e8 at 8192 x 4096 x W = 1, about 3 us at the
// H100's int32 rate; counted over (row, live source) pairs, a twentieth of
// that at a Bernoulli 0.05 frame, where the launch, the loads and the
// compaction take the time, not the compares.  The bytes (tags, flags and
// counts, 84 KB) are negligible.
//
// Interface: plain C entry points (loaded with ctypes by
// repro_torch/kernels/cam_search/kernel.py); they launch on the given stream,
// do not synchronise, allocate nothing and return the cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 1024;              // counts block: 32 warps
constexpr int kWarps = kThreads / 32;
constexpr int kR = 2;                       // query rows per thread
constexpr int kTileRows = 32 * kR;          // query rows per counts block
constexpr int kSub = 4;                     // sources a thread stages a pass
constexpr int kTileWords = kSub * kThreads; // tag words staged a pass
constexpr unsigned kFull = 0xffffffffu;

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

// Compare the `live_n` (1-4) live tags of one group, word-major at `g4`,
// with the thread's R query rows, adding the matches to `cnt`.  The counts
// are whole numbers below 2^24 held in float32 registers: exact, and their
// adds (predicated FADD) issue to the FMA pipe beside the compares on the
// integer pipe, which is what bounds this loop.
template <int kW>
__device__ __forceinline__ void count_group(const int32_t* live, int cap,
                                            int g4, int live_n,
                                            int32_t (&q_reg)[kR][kW],
                                            float (&cnt)[kR]) {
  int4 tg[kW];
#pragma unroll
  for (int w = 0; w < kW; ++w)
    tg[w] = *reinterpret_cast<const int4*>(live + w * cap + g4);
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    bool e0 = true, e1 = live_n > 1, e2 = live_n > 2, e3 = live_n > 3;
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      e0 &= q_reg[k][w] == tg[w].x;
      e1 &= q_reg[k][w] == tg[w].y;
      e2 &= q_reg[k][w] == tg[w].z;
      e3 &= q_reg[k][w] == tg[w].w;
    }
    if (e0) cnt[k] += 1.0f;
    if (e1) cnt[k] += 1.0f;
    if (e2) cnt[k] += 1.0f;
    if (e3) cnt[k] += 1.0f;
  }
}

// The same for a runtime W: the query rows are read from device memory.
__device__ __forceinline__ void count_group_rt(const int32_t* live, int cap,
                                               int g4, int live_n, int W,
                                               const int32_t* (&q_row)[kR],
                                               float (&cnt)[kR]) {
  for (int j = g4; j < g4 + live_n; ++j) {
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      bool eq = true;
      for (int w = 0; w < W; ++w) eq &= q_row[k][w] == live[w * cap + j];
      if (eq) cnt[k] += 1.0f;
    }
  }
}

// counts[l, b] for the 64 rows of query tile blockIdx.x, lane blockIdx.y,
// over every entry, staged `tile` entries at a time.
template <int kW>
__global__ void __launch_bounds__(kThreads)
cam_match_counts_kernel(const int32_t* __restrict__ q,
                        const int32_t* __restrict__ t,
                        const uint8_t* __restrict__ valid,
                        int32_t* __restrict__ counts, int B, int E, int W,
                        int tile) {
  extern __shared__ __align__(16) int32_t live[];   // W rows of cap words
  __shared__ int32_t warp_live[kWarps];    // live tags of each warp's sources
  __shared__ int32_t partial[kWarps][kTileRows];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w_n = kW > 0 ? kW : W;
  const int cap = (tile + 3) & ~3;
  const int row0 = blockIdx.x * kTileRows;
  const uint8_t* v_lane = valid + (size_t)blockIdx.y * E;

  // this thread's query rows: registers when W is fixed, else device memory
  constexpr int kWr = kW > 0 ? kW : 1;
  int32_t q_reg[kR][kWr];
  const int32_t* q_row[kR];
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    q_row[k] = q + (size_t)min(row0 + k * 32 + lane, B - 1) * w_n;
    if constexpr (kW > 0) {
#pragma unroll
      for (int w = 0; w < kW; ++w) q_reg[k][w] = q_row[k][w];
    }
  }

  int cnt[kR];
#pragma unroll
  for (int k = 0; k < kR; ++k) cnt[k] = 0;
  for (int p0 = 0; p0 < E; p0 += tile) {
    const int p1 = min(E, p0 + tile);
    if (p0 > 0) __syncthreads();           // the previous pass is consumed
    // compact: the live tags of [p0, p1) (at most kSub sources a thread),
    // word-major; warp j's go after warps 0..j-1's
    unsigned mask[kSub];
    int mine = 0;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const int e = p0 + j * kThreads + threadIdx.x;
      mask[j] = __ballot_sync(kFull, e < p1 && v_lane[e] != 0);
      mine += __popc(mask[j]);
    }
    if (lane == 0) warp_live[warp] = mine;
    // the live sources' tags only, loaded while the block meets
    int32_t tw[kSub][kWr];
    if constexpr (kW > 0) {
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int e = p0 + j * kThreads + threadIdx.x;
#pragma unroll
        for (int w = 0; w < kW; ++w)
          tw[j][w] = (mask[j] >> lane) & 1 ? t[(size_t)e * kW + w] : 0;
      }
    }
    __syncthreads();
    int incl = warp_live[lane];            // this warp's offset, and n
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += up;
    }
    const int n = __shfl_sync(kFull, incl, 31);
    int at = __shfl_sync(kFull, incl, warp) - mine;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      if ((mask[j] >> lane) & 1) {
        const int slot = at + __popc(mask[j] & ((1u << lane) - 1u));
        const int e = p0 + j * kThreads + threadIdx.x;
        if constexpr (kW > 0) {
#pragma unroll
          for (int w = 0; w < kW; ++w) live[w * cap + slot] = tw[j][w];
        } else {
          for (int w = 0; w < W; ++w)
            live[w * cap + slot] = t[(size_t)e * W + w];
        }
      }
      at += __popc(mask[j]);
    }
    __syncthreads();

    // compare: warp j takes groups j, j + 32, ... of four live tags; the
    // last group may hold fewer
    float fcnt[kR];
#pragma unroll
    for (int k = 0; k < kR; ++k) fcnt[k] = 0.0f;
    const int full = n >> 2;
    if constexpr (kW > 0) {
#pragma unroll 2
      for (int g = warp; g < full; g += kWarps)
        count_group<kW>(live, cap, 4 * g, 4, q_reg, fcnt);
      if ((n & 3) != 0 && warp == full % kWarps)
        count_group<kW>(live, cap, 4 * full, n & 3, q_reg, fcnt);
    } else {
      for (int g = warp; g < full; g += kWarps)
        count_group_rt(live, cap, 4 * g, 4, W, q_row, fcnt);
      if ((n & 3) != 0 && warp == full % kWarps)
        count_group_rt(live, cap, 4 * full, n & 3, W, q_row, fcnt);
    }
#pragma unroll
    for (int k = 0; k < kR; ++k) cnt[k] += (int)fcnt[k];
  }

  // the 32 warps' counts of each row, summed in warp order
#pragma unroll
  for (int k = 0; k < kR; ++k) partial[warp][k * 32 + lane] = cnt[k];
  __syncthreads();
  if (threadIdx.x < kTileRows && row0 + (int)threadIdx.x < B) {
    int sum = 0;
#pragma unroll
    for (int x = 0; x < kWarps; ++x) sum += partial[x][threadIdx.x];
    counts[(size_t)blockIdx.y * B + row0 + threadIdx.x] = sum;
  }
}

template <int kW>
cudaError_t launch_counts(const int32_t* q, const int32_t* t,
                          const uint8_t* valid, int32_t* counts, int lanes,
                          int B, int E, int W, cudaStream_t stream) {
  const int tile = std::max(1, std::min(E, kTileWords / W));
  const size_t smem = (size_t)W * ((tile + 3) & ~3) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cam_match_counts_kernel<kW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((B + kTileRows - 1) / kTileRows, lanes);
  cam_match_counts_kernel<kW><<<grid, kThreads, smem, stream>>>(
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
#define COUNTS(k) launch_counts<k>(q, t, valid, counts, lanes, B, E, W, s)
    case 1: return COUNTS(1);
    case 2: return COUNTS(2);
    case 3: return COUNTS(3);
    case 4: return COUNTS(4);
    default: return COUNTS(0);
#undef COUNTS
  }
}

}  // extern "C"
