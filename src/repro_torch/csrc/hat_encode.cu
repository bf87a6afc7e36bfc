// Hierarchical address-event encoding for Hopper (sm_90a).
//
// Replaces the TPU kernel `hat_encode_pallas` (src/repro/kernels/hat_encode/
// kernel.py:50, body `_hat_encode_kernel`), with two entry points.
//
// hat_encode_launch - the op `hat_encode` / `encode_stream` on a caller's
// bitmaps.  From a spike bitmap (N,) it computes the service rank of every
// neuron (inclusive prefix count - 1 in ascending address order, -1 where
// silent), the event count of every cluster of `row` consecutive neurons,
// and the total; in the same pass it writes the AER stream `compact_stream`
// makes of the ranks: stream[rank[i]] = i, padded with N after the last
// event.
//
// Design.  The TPU kernel scans with two triangular f32 matmuls, an idiom of
// its matrix unit.  Here the scan is integer and exact by construction: one
// block per bitmap, 256 threads over chunks of 256 neurons.  Within a warp,
// __ballot_sync gives the chunk's spike mask and __popc of its lower lanes
// each neuron's prefix; warp 0 scans the eight warp totals with shuffles; a
// carry takes the count from one chunk to the next, so any N up to 2^16 (the
// JAX bound) is one block.  A cluster's count is the inclusive prefix at its
// last neuron less the exclusive prefix at its first: the first neuron's
// thread stores that prefix in the output, and after a barrier the last
// neuron's thread turns it into the count.
//
// hat_run_launch - the interface tick's use of the stream, for every
// (tick, lane, core) bitmap of a session run in one launch (the op
// `hat_run`).  The tick never reads the ranks or the stream themselves: it
// takes from them, and from the frame, the arbiter's tick latency (the
// scheme's dense closed form), the AER encode energy of the stream
// (`arbiter.encode_energy_units`) and the event count.  Launched once per
// tick with the ranks, clusters and stream written to memory and some twenty
// small torch ops around it, that cost a 1.6 us launch, a 56 us wrapper call
// and the ops' dispatch each tick.  The frames of a run are all known before
// its first tick and nothing here depends on a tick's result, so one launch
// does them all, and only the three (T, B, C) results leave the chip's
// registers.
//
// Design.  One warp per bitmap, 8 or 16 warps a block, no atomics and no
// shared memory.  A lane reads 8 neurons as one 8-byte word, so a warp takes
// 256 neurons a chunk, and carries what it needs from chunk to chunk: any n
// up to 2^16.  Each lane folds its word into an 8-bit mask, whose __popc
// counts its events.  The AER stream is ascending, so an event's
// predecessor in it is the previous set bit of its lane, or the last event
// of the nearest lower lane that has one (a shuffle max-scan), or the
// carry (-1 before the first event); its successor likewise (a shuffle
// min-scan, within the chunk: hier_ring's sections of sqrt(n) >= 16 neurons
// hold whole lanes and never straddle a chunk).  Per scheme (a template
// branch, ids of ArbiterScheme.kernel_policy):
//   binary_tree, greedy_tree  latency from the count k;
//   token_ring                from the last event;
//   hier_ring                 from the first and last occupied sections and
//                             the sum of each section's last lo (`lo_max`):
//                             an event whose successor lies in another
//                             section is its section's last;
//   hier_tree                 q counts the events whose cluster prefix
//                             (>> 2 (levels - 1)) differs from their
//                             predecessor's; the encode toggles are 2 for
//                             each level whose address prefix differs, with
//                             the stream's edges: the first element against
//                             -1, and the first pad n against the last event
//                             when k < n (an empty core is all pad: 2 levels
//                             toggles, not 0; a full core has no pad);
//   flat schemes              encode energy log2(n).
// Every latency is an exact small integer, rounded one float32 op at a time
// as the sparse tick's policies are; the energy is __fdiv_rn(toggles, n).
//
// Bound.  On the interface path (16 cores x 256 neurons a lane) the one-tick
// kernel moves some 37 KB a tick: it is bound by its launch, not by bytes or
// operations.  The whole-run kernel reads each frame byte once and writes 12
// bytes a bitmap: 1.1 MB for a 256-tick lane, 0.33 us at 3.35 TB/s, so it
// is bound by bytes.
//
// Interface: plain C entry points (loaded with ctypes by
// repro_torch/kernels/hat_encode/kernel.py); each launches on the given
// stream, does not synchronise, allocates nothing and returns the
// cudaError_t.

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


// ---------------------------------------------------------------------------
// The arbiter's tick terms of a whole session run.
// ---------------------------------------------------------------------------

constexpr int kRunThreads = 256;
constexpr int kRunWarps = kRunThreads / 32;
constexpr int kChunk = 256;                // neurons a warp reads at a time
constexpr int kNone = 0x7fffffff;          // no event (a min-scan's identity)

// Branch ids; the same numbers as ArbiterScheme.kernel_policy in
// repro_torch/core/arbiter.py.
enum Policy : int {
  kBinaryTree = 0,
  kGreedyTree = 1,
  kTokenRing = 2,
  kHierRing = 3,
  kHierTree = 4,
};

struct RunArgs {
  const uint8_t* stream;     // (B, T, C, n) bool frames
  float* lat;                // (T, B, C) arbiter tick latency
  float* enc;                // (T, B, C) encode energy per event
  int32_t* count;            // (T, B, C) events
  int lanes, ticks, cores, n;
  int levels;                // HAT levels
  int ring_shift;            // log2(sqrt n): a hier_ring section is a >> it
  float per_grant;           // 2 * (log2 n - 1)
  float log2n;
};

// Eight bool bytes -> an 8-bit mask, bit i set iff byte i is not zero.
__device__ __forceinline__ unsigned byte_mask(unsigned long long w) {
  w |= w >> 4;
  w |= w >> 2;
  w |= w >> 1;                             // any bit of a byte -> its bit 0
  w &= 0x0101010101010101ull;
  return static_cast<unsigned>((w * 0x0102040810204080ull) >> 56);
}

// How many HAT levels l see the address prefix a >> 2l differ from p >> 2l,
// uncapped: (a ^ p) >> 2l is not 0 for l < ceil(bitlen(a ^ p) / 2), and for
// every l when p = -1 (the sign bit), which gives 16.
__device__ __forceinline__ int prefix_levels(int a, int p) {
  return (33 - __clz(a ^ p)) >> 1;
}

template <int POLICY>
__global__ void __launch_bounds__(kRunThreads) hat_run_kernel(RunArgs a) {
  const int ln = threadIdx.x & 31;
  const long long r =
      static_cast<long long>(blockIdx.x) * kRunWarps + (threadIdx.x >> 5);
  const long long per_lane = static_cast<long long>(a.ticks) * a.cores;
  if (r >= per_lane * a.lanes) return;     // the whole warp leaves
  const int n = a.n;
  const unsigned long long* words =
      reinterpret_cast<const unsigned long long*>(a.stream + r * n);

  int events = 0;            // this lane's events
  int carry = -1;            // the last event of the chunks before
  int first = kNone;         // hier_ring: the first event
  int lo_sum = 0;            // hier_ring: this lane's sections' lo_max
  int toggles = 0, q = 0;    // hier_tree: this lane's events
  unsigned long long w = __ldg(words + ln);
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const unsigned long long ahead =
        c0 + kChunk < n ? __ldg(words + (c0 + kChunk) / 8 + ln) : 0ull;
    const unsigned m = byte_mask(w);
    w = ahead;
    const int base = c0 + 8 * ln;
    events += __popc(m);
    const int last = m ? base + 31 - __clz(m) : -1;   // the lane's last event
    if (POLICY == kTokenRing)
      carry = max(carry, __reduce_max_sync(kFull, last));
    if (POLICY == kHierRing) {
      int after = m ? base + __ffs(m) - 1 : kNone;    // min-scan from above
      for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_down_sync(kFull, after, o);
        if (ln + o < 32) after = min(after, up);
      }
      first = min(first, __shfl_sync(kFull, after, 0));
      int succ = __shfl_down_sync(kFull, after, 1);   // the next lane's on
      if (ln == 31) succ = kNone;
      if (m && (succ == kNone ||
                (succ >> a.ring_shift) != (last >> a.ring_shift)))
        lo_sum += last & ((1 << a.ring_shift) - 1);
      carry = max(carry, __reduce_max_sync(kFull, last));
    }
    if (POLICY == kHierTree) {
      int before = last;                              // max-scan from below
      for (int o = 1; o < 32; o <<= 1) {
        const int down = __shfl_up_sync(kFull, before, o);
        if (ln >= o) before = max(before, down);
      }
      int p = __shfl_up_sync(kFull, before, 1);       // the lower lanes' last
      p = max(ln == 0 ? -1 : p, carry);
      carry = max(carry, __shfl_sync(kFull, before, 31));
      for (unsigned bits = m; bits; bits &= bits - 1) {
        const int e = base + __ffs(bits) - 1;
        const int d = prefix_levels(e, p);
        toggles += min(d, a.levels);
        q += d >= a.levels;
        p = e;
      }
    }
  }

  const int k = __reduce_add_sync(kFull, events);
  const float kf = static_cast<float>(k);
  float lat = 0.0f, enc = a.log2n;
  if (POLICY == kBinaryTree) {
    lat = __fmul_rn(kf, a.per_grant);
  } else if (POLICY == kGreedyTree) {
    lat = k > 0 ? __fadd_rn(a.per_grant, __fmul_rn(kf - 1.0f, 3.0f)) : 0.0f;
  } else if (POLICY == kTokenRing) {
    lat = k > 0 ? __fadd_rn(static_cast<float>(carry), 1.0f) : 0.0f;
  } else if (POLICY == kHierRing) {
    lo_sum = __reduce_add_sync(kFull, lo_sum);
    const int s_first = first >> a.ring_shift, s_last = carry >> a.ring_shift;
    lat = k > 0 ? static_cast<float>(1 + s_first + 3 * (s_last - s_first) +
                                     lo_sum)
                : 0.0f;
  } else if (POLICY == kHierTree) {
    toggles = __reduce_add_sync(kFull, toggles);
    q = __reduce_add_sync(kFull, q);
    if (k < n) toggles += min(prefix_levels(n, carry), a.levels);  // first pad
    lat = k > 0 ? static_cast<float>(2 * a.levels + (k - 1) + (q - 1)) : 0.0f;
    enc = __fdiv_rn(static_cast<float>(2 * toggles), static_cast<float>(n));
  }
  if (ln == 0) {                           // (b, t, c) -> (t, b, c)
    const long long b = r / per_lane, tc = r % per_lane;
    const long long o =
        ((tc / a.cores) * a.lanes + b) * a.cores + tc % a.cores;
    a.lat[o] = lat;
    a.enc[o] = enc;
    a.count[o] = k;
  }
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

// (B, T, C, n) bool frames -> the arbiter's tick latency, the encode energy
// and the event count of each (tick, lane, core), written as three (T, B, C)
// arrays one after another at `out` (float32, float32, int32).  `policy` is
// the scheme's ArbiterScheme.kernel_policy; an n that is not a multiple of
// 256 or is over 2^16 is refused (cudaErrorInvalidValue), as is an unknown
// policy.
int hat_run_launch(int policy, const uint8_t* stream, float* out, int lanes,
                   int ticks, int cores, int n, int levels, int ring_shift,
                   float per_grant, float log2n, void* cuda_stream) {
  if (n <= 0 || n % kChunk || n > (1 << 16)) return cudaErrorInvalidValue;
  const long long bitmaps = static_cast<long long>(lanes) * ticks * cores;
  RunArgs a{stream, out, out + bitmaps,
            reinterpret_cast<int32_t*>(out + 2 * bitmaps), lanes, ticks,
            cores, n, levels, ring_shift, per_grant, log2n};
  const unsigned blocks =
      static_cast<unsigned>((bitmaps + kRunWarps - 1) / kRunWarps);
  const cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  switch (policy) {
    case kBinaryTree:
      hat_run_kernel<kBinaryTree><<<blocks, kRunThreads, 0, s>>>(a);
      break;
    case kGreedyTree:
      hat_run_kernel<kGreedyTree><<<blocks, kRunThreads, 0, s>>>(a);
      break;
    case kTokenRing:
      hat_run_kernel<kTokenRing><<<blocks, kRunThreads, 0, s>>>(a);
      break;
    case kHierRing:
      hat_run_kernel<kHierRing><<<blocks, kRunThreads, 0, s>>>(a);
      break;
    case kHierTree:
      hat_run_kernel<kHierTree><<<blocks, kRunThreads, 0, s>>>(a);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // extern "C"
