// Fused sparse event tick for Hopper (sm_90a).
//
// Replaces the TPU kernel `sparse_tick_pallas` (src/repro/kernels/sparse_tick/
// kernel.py:65, body `_fused_kernel`).  From the compacted per-core event
// buffer it computes, per core: the arbiter tick latency and the AER encode
// energy (the scheme's sparse policies), the CAM gather
// drive[e] = spikes[src_idx[e]] & active[e], the weighted scatter-add of the
// drive into the core's synaptic currents, and the core's CAM hit count.
//
// Two entry points share the scheme's policies:
//
// sparse_tick_launch - one tick from a caller's event buffer (the op
//   `kernels.sparse_tick.ops.sparse_tick`).  Each (core, batch lane) is one
//   thread block: warp 0 computes latency and encode energy from the buffer
//   row, all threads gather the core's contributions into shared memory and
//   reduce its hit count, and one thread per target walks its CSR segment.
//
// sparse_run_launch - every sparse tick of a session run in one launch (the
//   op `kernels.sparse_tick.ops.sparse_run`).  The Pallas kernel works on one
//   compacted tick; the session around it compacted, gathered the NoC tables
//   and reduced the stats with some sixty small torch ops a tick, each its own
//   host dispatch, so the card sat idle 0.94 of the time.  The ticks of a run
//   are independent (only the stats accumulator carries), so here each
//   (tick, lane) is one block, and it does the whole tick from the bool frame:
//     1. the frame (cores * n bytes) and the CSR segment offsets are staged
//        into shared memory with cp.async while the CSR-ordered CAM operands
//        (source index and weight of each live entry, permuted at plan
//        time) are loaded, so the block pays about
//        two global round trips, not five dependent ones; each entry's
//        contribution spikes[src] ? w : 0 goes to shared memory in CSR
//        order;
//     2. a warp per core compacts its ascending event addresses into K + 1
//        shared slots padded with n (a ballot/popc scan, as hat_encode.cu)
//        and computes the scheme's latency and encode energy from them;
//     3. the event-indexed accounting compacts the tick's events into a
//        list and gathers each event's NoC table entries (hops, depth,
//        subscribed cores, swept entries, link row) and, on a multi-chip
//        fabric, its inter-chip tier's (chip hops, chip depth, and the
//        chip links' columns, stored after the local links' in one row);
//        every sum is of exact small integers, so its order is free: link
//        l's load is summed by groups of threads, each over every G-th
//        event, and the groups' partials added after (shared float atomics
//        on the few link addresses contended and took a third of a block's
//        time);
//     4. each target's CSR segment is summed in ascending entry order from
//        0.0 (the JAX scatter's order), a thread walking eight targets'
//        segments side by side, and the currents are written;
//     5. the stats tail (`pipeline._stats`, `cam.energy`, `router._latency`)
//        runs one float32 operation at a time, each rounded as torch rounds
//        it (__fmul_rn, __fadd_rn, __fdiv_rn: no contraction), and writes the
//        tick's 12 StepStats fields as one row of a (T, 12, B) table: the
//        chip tier's three (hops, depth x hop time + busiest chip link x
//        serialization, hops x hop energy; `hierarchy.chip_step_costs`) or,
//        on one chip, zeros.  On request it also writes each core's arbiter
//        latency and encode energy (the per-core telemetry).
//   The last block to finish (a global counter, which that block's
//   atomicInc wraps back to 0 for the next launch) sums the table in tick
//   order per (field, lane), as the JAX lax.scan carry does: from the
//   caller's seed acc0[field, lane] (a served lane's accumulator carried
//   from its previous chunk), or from 0.0 without one.  The seed is the
//   sum's first term, not added after it: float addition is not
//   associative, and only the seeded order gives a chunked stream the
//   bits of one uninterrupted run.  The session writes its dense fallback
//   ticks' rows before the launch.
//
//   One block holds a whole (tick, lane) where the fabric fits a block's
//   227 KB of shared memory (at 64 cores x 256 neurons x 512 entries, nine
//   in ten of them live, 221 KB).  A larger fabric takes the group form
//   (kernel.py `plan_groups`, chosen once at bind time): the (tick, lane)
//   is cut into G groups of consecutive cores, one block a (tick, lane,
//   group).  A group's targets are a contiguous range of the CSR order, so
//   its live entries are too: the block stages its cores' frames, its
//   entries' contributions and its targets' CSR offsets, compacts its own
//   cores' events, computes their arbiter latency and encode energy, walks
//   its own targets' segments and does its own events' accounting, reading
//   from global memory (L2) what it does not hold: every source's spike
//   (a source may lie in any core), and where even one core does not fit
//   a block the part that core needs most of (the CSR offsets of a core
//   with very many neurons, the contributions of one with very many
//   entries, its frame, its event buffers, the last kept in a scratch).
//   Each target is still summed in one block in ascending entry order from
//   0.0, so the currents keep their bits; every sum across groups is
//   order-free (integer counts, maxima, exact dyadic energies, link loads
//   that are whole numbers below 2^24) and goes into a per-(tick, lane)
//   scratch by atomics; the last group of a (tick, lane) (a counter that
//   wraps back to 0) writes its row.  So B1 takes every fabric the TPU
//   kernel takes (cores x entries up to MAX_FUSED_ELEMS = 2^22).  A thread
//   block cluster alone would not: 16 blocks x 227 KB is below the 16 MB
//   of contributions at 2^22 live entries, and splitting the cores over a
//   cluster was timed to help only when a run has fewer (tick, lane)
//   items than the card has SMs.
//
// Bound.  At 16 cores x 256 neurons x 512 entries, capacity 32, a 256-tick
// Bernoulli 0.05 run must read the 1 MB of frames, the routing operands and
// the NoC table rows once and write 4 MB of currents: about 1.7 us at
// 3.35 TB/s, so the run is bound by bytes.  In practice a block's latency
// bounds it, spread over the phases above (the currents and the link loads
// the largest), with the last block's tick-order sum after it.
//
// Interface: plain C entry points (loaded with ctypes by
// repro_torch/kernels/sparse_tick/kernel.py); each launches on the given
// stream, does not synchronise, allocates nothing and returns the
// cudaError_t.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRunThreads = 512;
constexpr int kRunWarps = kRunThreads / 32;
constexpr int kFields = 12;   // StepStats fields
// what a group block holds in shared memory; the same bits as STAGE_* in
// repro_torch/kernels/sparse_tick/kernel.py
constexpr int kStageFrame = 1, kStageContrib = 2, kStageSeg = 4,
              kStageEvents = 8;
// a (tick, lane)'s words of item_acc before its link loads: events, hits,
// hops, dest, swept, depth, chip hops, chip depth, latency (float bits,
// max), encode energy (float), groups finished
constexpr int kItemWords = 12;
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

// The scheme's static quantities.
struct PolicyArgs {
  int n, slots;              // neurons per core, buffer slots (K + 1)
  int levels;                // HAT levels
  int sqrt_n, ring_shift;    // hier_ring sections and log2(sqrt_n)
  float per_grant;           // 2 * (log2 n - 1)
  float log2n;
};

struct Args {
  PolicyArgs p;
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
  int cores, entries;
};

struct RunArgs {
  PolicyArgs p;
  const uint8_t* stream;     // (B, T, C, n) bool frames
  const int32_t* ticks;      // (sparse ticks,) tick ids, or null: 0 .. T-1
  const int32_t* ptr;        // (C * n + 1,) CSR segment offsets
  const int32_t* src;        // (nnz,) flat source of a live entry, CSR order
  const float* weight;       // (nnz,) its weight, CSR order
  const int32_t* hops;       // (S,) mesh links per event
  const int32_t* depth;      // (S,) deepest path per event
  const int32_t* dest;       // (S,) subscribed cores per event
  const int32_t* swept;      // (S,) CAM entries swept per event
  const float* links;        // (S, L) events per link per event: the
                             // noc_links_n local links, then the chip links
  const int32_t* chip_hops;  // (S,) inter-chip links per event, or null:
                             // one chip, rows 9-11 are 0
  const int32_t* chip_depth; // (S,) deepest inter-chip path per event
  float* core_out;           // (2, T, B, C) latency, encode energy x events
                             // of each core, or null
  float* currents;           // (B, T, C, n)
  float* table;              // (T, 12, B) per-tick stats
  float* acc;                // (12, B) the table summed in tick order
  const float* acc0;         // (12, B) the sum's seed, or null: 0.0
  unsigned* done;            // finished (tick, lane) items; 0 at launch,
                             // 0 again after it
  const int32_t* group_start;  // (G + 1,) first core of each group, or
                               // null: one block a (tick, lane)
  int* item_acc;             // (items, item_stride) zeroed: each (tick,
                             // lane)'s partial sums (kItemWords), then its
                             // link loads; group form only
  int* spill;                // event buffers and lists of the blocks that
                             // do not hold them, or null
  int groups, group_cores;   // G, and the most cores in a group
  int stage;                 // kStage* parts a group block holds
  int item_stride;           // ints a (tick, lane) of item_acc
  int lanes, ticks_total, items, cores, links_n, noc_links_n;
  int flood;                 // 1: every event searched in every core
  int vec;                   // frames 16-byte aligned: stage with cp.async
  int contrib_cap;           // live CAM entries (contribution slots)
  int stage_floats;          // dynamic shared memory, in floats
  float flood_eps;           // flood entries per search (mean valid count)
  float cam_cycle_ns, e_match, e_mm, e_fixed;
  float hop_ns, link_ns, hop_energy;
  float chip_hop_ns, chip_link_ns, chip_hop_energy;
};

// A (tick, lane)'s integer and float reductions.
struct Partial {
  int events, hits, hops, dest, swept, depth, chops, cdepth;
  float lat, enc;
};

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_fmax(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_fsum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The scheme's latency and encode energy of one core's buffer row, run by
// the 32 lanes of one warp; every lane returns the same (latency, energy).
// ``lo_max`` is the warp's hier_ring scratch, -1 on entry.
template <int POLICY>
__device__ float2 policies(const PolicyArgs& a, const int32_t* row, int k,
                           int* lo_max) {
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
  return make_float2(lat, enc);
}

// ---------------------------------------------------------------------------
// One tick from a caller's event buffer.
// ---------------------------------------------------------------------------

template <int POLICY>
__global__ void __launch_bounds__(kThreads) sparse_tick_kernel(Args a) {
  extern __shared__ float smem[];
  float* contrib = smem;                                    // [entries]
  int* lo_max = reinterpret_cast<int*>(smem + a.entries);   // [sqrt_n]
  __shared__ int warp_hits[kWarps];

  const int n = a.p.n;
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int row_id = b * a.cores + c;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int ln = tid & 31;

  if (POLICY == kHierRing) {
    for (int s = tid; s < a.p.sqrt_n; s += blockDim.x) lo_max[s] = -1;
    __syncthreads();
  }

  // 1. arbiter latency + AER encode energy from the event buffer
  if (warp == 0) {
    const float2 le = policies<POLICY>(
        a.p, a.buf + static_cast<size_t>(row_id) * a.p.slots,
        a.counts[row_id], lo_max);
    if (ln == 0) {
      a.lat[row_id] = le.x;
      a.enc[row_id] = le.y;
    }
  }

  // 2. CAM gather: contributions of the core's entries, and its hit count
  const uint8_t* spikes = a.spikes + static_cast<size_t>(b) * a.cores * n;
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
  float* out = a.currents + static_cast<size_t>(row_id) * n;
  for (int t = tid; t < n; t += blockDim.x) {
    const int g = c * n + t;
    float acc = 0.0f;
    for (int p = a.csr_ptr[g]; p < a.csr_ptr[g + 1]; ++p)
      acc = __fadd_rn(acc, contrib[a.csr_entry[p] - entry0]);
    out[t] = acc;
  }
}

template <int POLICY>
cudaError_t launch(const Args& a, int lanes, cudaStream_t stream) {
  size_t smem = static_cast<size_t>(a.entries) * sizeof(float);
  if (POLICY == kHierRing) smem += static_cast<size_t>(a.p.sqrt_n) * sizeof(int);
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

// ---------------------------------------------------------------------------
// Every sparse tick of a run.
// ---------------------------------------------------------------------------

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// The stats tail of one (tick, lane), from its reductions; the order and
// rounding of pipeline._stats, cam.energy and router._latency.
__device__ void stats_row(const RunArgs& a, const Partial& s, float busiest,
                          float cbusiest, float* row) {
  const float events = static_cast<float>(s.events);
  float searches, eps;
  if (a.flood) {
    searches = __fmul_rn(events, static_cast<float>(a.cores));
    eps = a.flood_eps;
  } else {
    searches = static_cast<float>(s.dest);
    eps = __fdiv_rn(static_cast<float>(s.swept), fmaxf(searches, 1.0f));
  }
  const float match = __fdiv_rn(static_cast<float>(s.hits),
                                fmaxf(searches, 1.0f));
  const float mismatch = __fsub_rn(eps, match);
  const float energy = __fadd_rn(
      __fadd_rn(__fmul_rn(match, a.e_match), __fmul_rn(mismatch, a.e_mm)),
      a.e_fixed);
  const float hops = static_cast<float>(s.hops);
  row[0] = events;                                      // events
  row[1] = s.lat;                                       // encode_latency
  row[2] = s.enc;                                       // encode_energy
  row[3] = searches;                                    // cam_searches
  row[4] = __fmul_rn(searches, energy);                 // cam_energy
  row[5] = __fmul_rn(searches, a.cam_cycle_ns);         // cam_time_ns
  row[6] = hops;                                        // noc_hops
  row[7] = __fadd_rn(__fmul_rn(static_cast<float>(s.depth), a.hop_ns),
                     __fmul_rn(busiest, a.link_ns));    // noc_latency
  row[8] = __fmul_rn(hops, a.hop_energy);               // noc_energy
  const float chops = static_cast<float>(s.chops);
  const bool chip = a.chip_hops != nullptr;
  row[9] = chip ? chops : 0.0f;                         // chip_hops
  row[10] = chip ? __fadd_rn(__fmul_rn(static_cast<float>(s.cdepth),
                                       a.chip_hop_ns),
                             __fmul_rn(cbusiest, a.chip_link_ns))
                 : 0.0f;                                // chip_latency
  row[11] = chip ? __fmul_rn(chops, a.chip_hop_energy) : 0.0f;  // chip_energy
}

// 2. compaction and the scheme's policies, a warp per core, for the
// block's ``cores`` cores (the fabric's c0, c0 + 1, ...; core lc's frame at
// frame + lc * n): each core's ascending event addresses into its K + 1
// slots of ``buf`` padded with n, its event count, arbiter latency and
// encode energy x events, and on request the per-core output.
template <int POLICY>
__device__ __forceinline__ void compact_cores(
    const RunArgs& a, const uint8_t* frame, int cores, int c0, int t, int b,
    int* buf, int* cnt, float* lat, float* encc, int* lo_max) {
  const int n = a.p.n, slots = a.p.slots;
  const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
  int* lm = lo_max + warp * a.p.sqrt_n;
  for (int lc = warp; lc < cores; lc += kRunWarps) {
    const uint8_t* fr = frame + static_cast<size_t>(lc) * n;
    int* row = buf + lc * slots;
    int count = 0;
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + ln;
      const bool on = j < n && fr[j];
      const unsigned m = __ballot_sync(kFull, on);
      if (on) {
        const int pos = count + __popc(m & ((1u << ln) - 1u));
        if (pos < slots) row[pos] = j;
      }
      count += __popc(m);
    }
    for (int j = min(count, slots) + ln; j < slots; j += 32) row[j] = n;
    if (POLICY == kHierRing)
      for (int q = ln; q < a.p.sqrt_n; q += 32) lm[q] = -1;
    __syncwarp();
    const float2 le = policies<POLICY>(a.p, row, count, lm);
    if (ln == 0) {
      const float e = __fmul_rn(le.y, static_cast<float>(count));
      cnt[lc] = count;
      lat[lc] = le.x;
      encc[lc] = e;
      if (a.core_out != nullptr) {
        const size_t plane = static_cast<size_t>(a.ticks_total) * a.lanes *
                             a.cores;
        const size_t at = (static_cast<size_t>(t) * a.lanes + b) * a.cores +
                          c0 + lc;
        a.core_out[at] = le.x;
        a.core_out[plane + at] = e;
      }
    }
    __syncwarp();
  }
}

// 3. the block's events over the first K slots of each core, as flat
// sources in core order (warp 0 scans the per-core counts into ``off``);
// returns their number.  Every thread of the block calls it.
__device__ __forceinline__ int event_list(const RunArgs& a, int cores,
                                          int c0, const int* buf,
                                          const int* cnt, int* off, int* ev,
                                          int& n_events) {
  const int n = a.p.n, slots = a.p.slots, cap = slots - 1;
  const int tid = threadIdx.x, warp = tid >> 5, ln = tid & 31;
  if (warp == 0) {
    int total = 0;
    for (int b0 = 0; b0 < cores; b0 += 32) {
      const int lc = b0 + ln;
      const int v = lc < cores ? min(cnt[lc], cap) : 0;
      int incl = v;
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(kFull, incl, o);
        if (ln >= o) incl += u;
      }
      if (lc < cores) off[lc] = total + incl - v;
      total += __shfl_sync(kFull, incl, 31);
    }
    if (ln == 0) n_events = total;
  }
  __syncthreads();
  for (int i = tid; i < cores * cap; i += kRunThreads) {
    const int lc = i / cap, j = i - lc * cap;
    if (j < min(cnt[lc], cap))
      ev[off[lc] + j] = (c0 + lc) * n + buf[lc * slots + j];
  }
  __syncthreads();
  return n_events;
}

// The events' table entries, summed (maxima for the depths) by the block
// into ``part`` with the thread's CAM hits; exact integers, so the order
// is free.  Every thread of the block calls it; ``part`` is ready after
// the caller's next __syncthreads.
__device__ __forceinline__ void tally_events(const RunArgs& a, const int* ev,
                                             int nev, int hit,
                                             Partial& part) {
  int hops = 0, dest = 0, swept = 0, depth = 0, chops = 0, cdepth = 0;
  for (int e = threadIdx.x; e < nev; e += kRunThreads) {
    const int src = ev[e];
    hops += a.hops[src];
    depth = max(depth, a.depth[src]);
    if (!a.flood) {
      dest += a.dest[src];
      swept += a.swept[src];
    }
    if (a.chip_hops != nullptr) {
      chops += a.chip_hops[src];
      cdepth = max(cdepth, a.chip_depth[src]);
    }
  }
  hit = warp_sum(hit);
  hops = warp_sum(hops);
  dest = warp_sum(dest);
  swept = warp_sum(swept);
  depth = warp_max(depth);
  chops = warp_sum(chops);
  cdepth = warp_max(cdepth);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&part.hits, hit);
    atomicAdd(&part.hops, hops);
    atomicAdd(&part.dest, dest);
    atomicAdd(&part.swept, swept);
    atomicMax(&part.depth, depth);
    atomicAdd(&part.chops, chops);
    atomicMax(&part.cdepth, cdepth);
  }
}

// The one-block form: block ``item`` holds the whole (tick, lane), 1-5.
template <int POLICY>
__device__ __forceinline__ void one_block(const RunArgs& a,
                                          unsigned char* run_smem,
                                          int& is_last) {
  __shared__ Partial part;
  __shared__ int n_events;

  const int n = a.p.n, slots = a.p.slots, cap = slots - 1;
  const int cores = a.cores;
  const int fabric = cores * n;
  const int tid = threadIdx.x, warp = tid >> 5, ln = tid & 31;
  const int item = blockIdx.x;

  uint8_t* frame = run_smem;                                 // [fabric]
  float* contrib = reinterpret_cast<float*>(run_smem + align16(fabric));
  int* seg = reinterpret_cast<int*>(contrib + a.contrib_cap);  // [fabric + 1]
  int* buf = seg + fabric + 1;                               // [C][slots]
  int* ev = buf + cores * slots;                             // [C * cap]
  int* cnt = ev + cores * cap;                               // [C]
  int* off = cnt + cores;                                    // [C]
  float* lat = reinterpret_cast<float*>(off + cores);        // [C]
  float* encc = lat + cores;                                 // [C]
  int* lo_max = reinterpret_cast<int*>(encc + cores);        // [warps][sqrt_n]
  float* loads = reinterpret_cast<float*>(lo_max + kRunWarps * a.p.sqrt_n);
  float* gpart = loads + a.links_n;                          // [max(512, L)]

  if (tid == 0) is_last = 0;
  if (item < a.items) {
    const int b = item % a.lanes;
    const int k = item / a.lanes;
    const int t = a.ticks ? a.ticks[k] : k;
    const size_t fi = static_cast<size_t>(b) * a.ticks_total + t;
    const uint8_t* g = a.stream + fi * fabric;
    const int L = a.links_n;

    // 1. stage the frame; meanwhile load the CSR operands
    if (a.vec) {
      for (int q = tid; q < fabric / 16; q += kRunThreads)
        cp_async16(frame + 16 * q, g + 16 * q);
    } else {
      for (int q = tid; q < fabric; q += kRunThreads) frame[q] = g[q];
    }
    for (int q = tid; q <= fabric; q += kRunThreads)
      cp_async4(seg + q, a.ptr + q);
    if (tid == 0) part = Partial{0, 0, 0, 0, 0, 0, 0, 0, 0.0f, 0.0f};
    const int e1 = a.contrib_cap;
    constexpr int R = 8;
    int hit = 0;
    bool staged = false;
    for (int base = 0; base < e1 || !staged; base += kRunThreads * R) {
      int s[R];
      float w[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int p = base + r * kRunThreads + tid;
        s[r] = p < e1 ? a.src[p] : 0;
        w[r] = p < e1 ? a.weight[p] : 0.0f;
      }
      if (!staged) {                 // uniform: every thread takes it once
        cp_async_wait_all();
        __syncthreads();
        staged = true;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int p = base + r * kRunThreads + tid;
        if (p < e1) {
          const bool d = frame[s[r]];
          contrib[p] = d ? w[r] : 0.0f;
          hit += d;
        }
      }
    }

    compact_cores<POLICY>(a, frame, cores, 0, t, b, buf, cnt, lat, encc,
                          lo_max);
    __syncthreads();

    // 3. event-indexed accounting: the tick's events, their table entries
    // and link rows
    const int nev = event_list(a, cores, 0, buf, cnt, off, ev, n_events);
    // link loads: G groups of L threads, thread (g, l) sums link l of the
    // events g, g + G, ...; then each link adds its G partials (exact
    // integers: the order is free, and no shared atomics contend)
    const int groups = max(1, kRunThreads / max(L, 1));
    for (int q = tid; q < groups * L; q += kRunThreads) {
      const int g = q / L, l = q - g * L;
      float v = 0.0f;
      int e = g;
      for (; e + 3 * groups < nev; e += 4 * groups) {
        float x[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          x[u] = a.links[static_cast<size_t>(ev[e + u * groups]) * L + l];
#pragma unroll
        for (int u = 0; u < 4; ++u) v += x[u];
      }
      for (; e < nev; e += groups)
        v += a.links[static_cast<size_t>(ev[e]) * L + l];
      gpart[q] = v;
    }
    __syncthreads();
    for (int l = tid; l < L; l += kRunThreads) {
      float v = 0.0f;
      for (int g = 0; g < groups; ++g) v += gpart[g * L + l];
      loads[l] = v;
    }

    // 4. currents: each target's live entries in ascending order from 0.0;
    // a thread walks U targets' segments side by side (U independent chains)
    constexpr int U = 8;
    float* out = a.currents + fi * fabric;
    for (int g0 = tid; g0 < fabric; g0 += kRunThreads * U) {
      int p[U], end[U], longest = 0;
      float acc[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int gl = g0 + u * kRunThreads;
        p[u] = gl < fabric ? seg[gl] : 0;
        end[u] = gl < fabric ? seg[gl + 1] : 0;
        acc[u] = 0.0f;
        longest = max(longest, end[u] - p[u]);
      }
      for (int j = 0; j < longest; ++j) {
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (p[u] + j < end[u]) acc[u] = __fadd_rn(acc[u], contrib[p[u] + j]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (g0 + u * kRunThreads < fabric)
          out[g0 + u * kRunThreads] = acc[u];
    }

    // 5. the block's sums, then the row
    tally_events(a, ev, nev, hit, part);
    __syncthreads();
    if (warp == 0) {           // latencies are >= 0; energies exact dyadics
      int events = 0;
      float lmax = 0.0f, esum = 0.0f;
      for (int lc = ln; lc < cores; lc += 32) {
        events += cnt[lc];
        lmax = fmaxf(lmax, lat[lc]);
        esum += encc[lc];
      }
      events = warp_sum(events);
      lmax = warp_fmax(lmax);
      esum = warp_fsum(esum);
      if (ln == 0) {
        part.events = events;
        part.lat = lmax;
        part.enc = esum;
      }
    }
    __syncthreads();
    if (warp == 0) {
      float busiest = 0.0f, cbusiest = 0.0f;
      for (int l = ln; l < a.noc_links_n; l += 32)
        busiest = fmaxf(busiest, loads[l]);
      for (int l = a.noc_links_n + ln; l < L; l += 32)
        cbusiest = fmaxf(cbusiest, loads[l]);
      busiest = warp_fmax(busiest);
      cbusiest = warp_fmax(cbusiest);
      if (ln == 0) {
        float row[kFields];
        stats_row(a, part, busiest, cbusiest, row);
        float* dst = a.table + static_cast<size_t>(t) * kFields * a.lanes + b;
        for (int f = 0; f < kFields; ++f) dst[f * a.lanes] = row[f];
        __threadfence();
        // wraps to 0 at the last item: the counter is ready for the next
        // launch on the stream
        is_last = atomicInc(a.done, static_cast<unsigned>(a.items) - 1) ==
                  static_cast<unsigned>(a.items) - 1;
      }
    }
  } else if (tid == 0) {
    is_last = 1;                     // no sparse tick: one block sums
  }
}

// The group form: block (item, group) holds the group's consecutive cores
// [c0, c1) of one (tick, lane), 1-5 over them: in shared memory the parts
// ``a.stage`` names, the rest read from (or, the event buffers, kept in)
// global memory; every source's spike is read from the frame in global
// memory (L2).  Each target's live entries are still summed in ascending
// entry order from 0.0 in one block, so the currents are the one-block
// form's bits.  The block adds its sums into its item's row of item_acc:
// counts with atomicAdd, maxima with atomicMax (latencies >= 0 as int
// bits), encode energies (exact dyadics) and link loads (whole numbers
// below 2^24) with float atomicAdd, so their order is free.  The item's
// last group (a counter that wraps back to 0) writes the stats row.
template <int POLICY>
__device__ __forceinline__ void group_block(const RunArgs& a,
                                            unsigned char* smem,
                                            int& is_last) {
  __shared__ Partial part;
  __shared__ int n_events, last_group;

  const int n = a.p.n, slots = a.p.slots, cap = slots - 1;
  const int fabric = a.cores * n;
  const int tid = threadIdx.x, warp = tid >> 5, ln = tid & 31;
  const int item = blockIdx.x / a.groups;

  if (tid == 0) is_last = 0;
  if (item >= a.items) {
    if (tid == 0) is_last = 1;       // no sparse tick: one block sums
    return;
  }
  const int grp = blockIdx.x - item * a.groups;
  const int b = item % a.lanes;
  const int k = item / a.lanes;
  const int t = a.ticks ? a.ticks[k] : k;
  const size_t fi = static_cast<size_t>(b) * a.ticks_total + t;
  const uint8_t* whole = a.stream + fi * fabric;      // the frame, global
  const int c0 = a.group_start[grp];
  const int gc = a.group_start[grp + 1] - c0;
  const int t0 = c0 * n, nt = gc * n;                 // the group's targets
  const int p0 = a.ptr[t0], p1 = a.ptr[t0 + nt];      // and live entries
  const int L = a.links_n;
  const bool hold_contrib = a.stage & kStageContrib;
  int* item_row = a.item_acc + static_cast<size_t>(item) * a.item_stride;

  // 1. this block's layout, the parts it holds staged with cp.async; the
  // group's contributions meanwhile
  unsigned char* at = smem;
  const uint8_t* frame = whole + t0;                 // [nt] its cores' frames
  if (a.stage & kStageFrame) {
    uint8_t* staged = at;
    if (a.vec && t0 % 16 == 0 && nt % 16 == 0) {
      for (int q = tid; q < nt / 16; q += kRunThreads)
        cp_async16(staged + 16 * q, frame + 16 * q);
    } else {
      for (int q = tid; q < nt; q += kRunThreads) staged[q] = frame[q];
    }
    frame = staged;
    at += align16(nt);
  }
  float* contrib = reinterpret_cast<float*>(at);     // [p1 - p0]
  if (hold_contrib) at += 4 * static_cast<size_t>(p1 - p0);
  const int* seg = a.ptr + t0;                       // [nt + 1] CSR offsets
  if (a.stage & kStageSeg) {
    int* staged = reinterpret_cast<int*>(at);
    for (int q = tid; q <= nt; q += kRunThreads)
      cp_async4(staged + q, a.ptr + t0 + q);
    seg = staged;
    at += 4 * static_cast<size_t>(nt + 1);
  }
  int* buf;                                          // [gc][slots]
  if (a.stage & kStageEvents) {
    buf = reinterpret_cast<int*>(at);
    at += 4 * static_cast<size_t>(gc) * (slots + cap);
  } else {
    buf = a.spill + static_cast<size_t>(blockIdx.x) * a.group_cores *
                        (slots + cap);
  }
  int* ev = buf + gc * slots;                        // [gc * cap]
  int* cnt = reinterpret_cast<int*>(at);             // [gc]
  int* off = cnt + gc;                               // [gc]
  float* lat = reinterpret_cast<float*>(off + gc);   // [gc]
  float* encc = lat + gc;                            // [gc]
  int* lo_max = reinterpret_cast<int*>(encc + gc);   // [warps][sqrt_n]

  if (tid == 0) part = Partial{0, 0, 0, 0, 0, 0, 0, 0, 0.0f, 0.0f};
  int hit = 0;
  if (hold_contrib) {
    constexpr int R = 8;
    for (int base = p0; base < p1; base += kRunThreads * R) {
      int s[R];
      float w[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int p = base + r * kRunThreads + tid;
        s[r] = p < p1 ? a.src[p] : 0;
        w[r] = p < p1 ? a.weight[p] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int p = base + r * kRunThreads + tid;
        if (p < p1) {
          const bool d = __ldg(whole + s[r]);
          contrib[p - p0] = d ? w[r] : 0.0f;
          hit += d;
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. compaction and the scheme's policies, a warp per core
  compact_cores<POLICY>(a, frame, gc, c0, t, b, buf, cnt, lat, encc, lo_max);
  __syncthreads();

  // 3. the group's events as flat sources in core order, and their link
  // loads: thread (g, l) sums link l of the events g, g + G, ... and adds
  // it into the item's load of link l
  const int nev = event_list(a, gc, c0, buf, cnt, off, ev, n_events);
  // (eight rows' loads ahead of their adds: at 128 cores and more a
  // block's events' link rows are megabytes, read mostly from L2)
  float* loads = reinterpret_cast<float*>(item_row + kItemWords);
  const int groups = max(1, kRunThreads / max(L, 1));
  for (int q = tid; q < groups * L; q += kRunThreads) {
    const int g = q / L, l = q - g * L;
    float v = 0.0f;
    int e = g;
    for (; e + 7 * groups < nev; e += 8 * groups) {
      float x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        x[u] = a.links[static_cast<size_t>(ev[e + u * groups]) * L + l];
#pragma unroll
      for (int u = 0; u < 8; ++u) v += x[u];
    }
    for (; e < nev; e += groups)
      v += a.links[static_cast<size_t>(ev[e]) * L + l];
    if (v != 0.0f) atomicAdd(loads + l, v);
  }

  // 4. currents: each of the group's targets' live entries in ascending
  // order from 0.0, U targets a thread side by side; the contributions
  // from shared memory or, where the block does not hold them, each
  // entry's own from global memory (the same value, so the same bits)
  constexpr int U = 8;
  float* out = a.currents + fi * fabric + t0;
  for (int g0 = tid; g0 < nt; g0 += kRunThreads * U) {
    int p[U], end[U], longest = 0;
    float acc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int gl = g0 + u * kRunThreads;
      p[u] = gl < nt ? seg[gl] : 0;
      end[u] = gl < nt ? seg[gl + 1] : 0;
      acc[u] = 0.0f;
      longest = max(longest, end[u] - p[u]);
    }
    for (int j = 0; j < longest; ++j) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int q = p[u] + j;
        if (q < end[u]) {
          float c;
          if (hold_contrib) {
            c = contrib[q - p0];
          } else {
            const bool d = __ldg(whole + a.src[q]);
            hit += d;
            c = d ? a.weight[q] : 0.0f;
          }
          acc[u] = __fadd_rn(acc[u], c);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (g0 + u * kRunThreads < nt) out[g0 + u * kRunThreads] = acc[u];
  }

  // 5. the block's sums into the item's row; the item's last group writes
  // the stats row
  tally_events(a, ev, nev, hit, part);
  __syncthreads();
  if (warp == 0) {
    int events = 0;
    float lmax = 0.0f, esum = 0.0f;
    for (int lc = ln; lc < gc; lc += 32) {
      events += cnt[lc];
      lmax = fmaxf(lmax, lat[lc]);
      esum += encc[lc];
    }
    events = warp_sum(events);
    lmax = warp_fmax(lmax);
    esum = warp_fsum(esum);
    if (ln == 0) {
      atomicAdd(item_row + 0, events);
      atomicAdd(item_row + 1, part.hits);
      atomicAdd(item_row + 2, part.hops);
      atomicAdd(item_row + 3, part.dest);
      atomicAdd(item_row + 4, part.swept);
      atomicMax(item_row + 5, part.depth);
      atomicAdd(item_row + 6, part.chops);
      atomicMax(item_row + 7, part.cdepth);
      atomicMax(item_row + 8, __float_as_int(lmax));
      atomicAdd(reinterpret_cast<float*>(item_row + 9), esum);
    }
  }
  __threadfence();                   // the sums and link loads, then the count
  __syncthreads();
  if (tid == 0)
    last_group = atomicInc(reinterpret_cast<unsigned*>(item_row + 10),
                           static_cast<unsigned>(a.groups) - 1) ==
                 static_cast<unsigned>(a.groups) - 1;
  __syncthreads();
  if (last_group && warp == 0) {
    __threadfence();
    const volatile int* h = item_row;
    const volatile float* ld = loads;
    float busiest = 0.0f, cbusiest = 0.0f;
    for (int l = ln; l < a.noc_links_n; l += 32)
      busiest = fmaxf(busiest, ld[l]);
    for (int l = a.noc_links_n + ln; l < L; l += 32)
      cbusiest = fmaxf(cbusiest, ld[l]);
    busiest = warp_fmax(busiest);
    cbusiest = warp_fmax(cbusiest);
    if (ln == 0) {
      const Partial s{h[0], h[1], h[2], h[3], h[4], h[5], h[6], h[7],
                      __int_as_float(h[8]), __int_as_float(h[9])};
      float row[kFields];
      stats_row(a, s, busiest, cbusiest, row);
      float* dst = a.table + static_cast<size_t>(t) * kFields * a.lanes + b;
      for (int f = 0; f < kFields; ++f) dst[f * a.lanes] = row[f];
      __threadfence();
      is_last = atomicInc(a.done, static_cast<unsigned>(a.items) - 1) ==
                static_cast<unsigned>(a.items) - 1;
    }
  }
}

// 6. the last block: the table summed in tick order from the seed (0.0
// without one), one thread per (field, lane), the rows staged into shared
// memory by cp.async in chunks (a row's fields are a multiple of 4 floats,
// 16-byte aligned)
__device__ __forceinline__ void sum_table(const RunArgs& a,
                                          unsigned char* run_smem) {
  const int tid = threadIdx.x;
  __threadfence();
  float* stage = reinterpret_cast<float*>(run_smem);
  const int pairs = kFields * a.lanes, T = a.ticks_total;
  for (int p0 = 0; p0 < pairs; p0 += kRunThreads) {
    const int P = min(kRunThreads, pairs - p0);
    const int rows = a.stage_floats / P;
    float acc = (a.acc0 != nullptr && tid < P) ? a.acc0[p0 + tid] : 0.0f;
    for (int t0 = 0; t0 < T; t0 += rows) {
      const int nrows = min(rows, T - t0);
      __syncthreads();             // the previous chunk is summed
      for (int q = 4 * tid; q < nrows * P; q += 4 * kRunThreads) {
        const int r = q / P;
        cp_async16(stage + q, a.table + static_cast<size_t>(t0 + r) * pairs +
                                  p0 + (q - r * P));
      }
      cp_async_wait_all();
      __syncthreads();
      if (tid < P) {               // eight loads ahead of their adds
        int r = 0;
        for (; r + 8 <= nrows; r += 8) {
          float x[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) x[u] = stage[(r + u) * P + tid];
#pragma unroll
          for (int u = 0; u < 8; ++u) acc = __fadd_rn(acc, x[u]);
        }
        for (; r < nrows; ++r) acc = __fadd_rn(acc, stage[r * P + tid]);
      }
    }
    if (tid < P) a.acc[p0 + tid] = acc;
  }
}

template <int POLICY, bool GROUPED>
__global__ void __launch_bounds__(kRunThreads) sparse_run_kernel(RunArgs a) {
  extern __shared__ __align__(16) unsigned char run_smem[];
  __shared__ int is_last;
  if constexpr (GROUPED) {
    group_block<POLICY>(a, run_smem, is_last);
  } else {
    one_block<POLICY>(a, run_smem, is_last);
  }
  __syncthreads();
  if (is_last) sum_table(a, run_smem);
}

template <int POLICY, bool GROUPED>
cudaError_t launch_form(const RunArgs& a, size_t smem, long long blocks,
                        cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      sparse_run_kernel<POLICY, GROUPED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  sparse_run_kernel<POLICY, GROUPED>
      <<<static_cast<unsigned>(blocks), kRunThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// One block a (tick, lane), or with group_start one a (tick, lane, group).
template <int POLICY>
cudaError_t launch_run(const RunArgs& a, size_t smem, cudaStream_t stream) {
  if (a.group_start == nullptr)
    return launch_form<POLICY, false>(a, smem, max(a.items, 1), stream);
  const long long blocks =     // no sparse tick: one block sums
      a.items > 0 ? static_cast<long long>(a.items) * a.groups : 1;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  return launch_form<POLICY, true>(a, smem, blocks, stream);
}

PolicyArgs policy_args(int n, int slots, int levels, int sqrt_n,
                       int ring_shift, float per_grant, float log2n) {
  PolicyArgs p;
  p.n = n;
  p.slots = slots;
  p.levels = levels;
  p.sqrt_n = sqrt_n;
  p.ring_shift = ring_shift;
  p.per_grant = per_grant;
  p.log2n = log2n;
  return p;
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
  a.p = policy_args(n, slots, levels, sqrt_n, ring_shift, per_grant, log2n);
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
  a.entries = entries;
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

// ``ints``: lanes, ticks_total, items, cores, links_n, flood, vec,
// contrib_cap, n, slots, levels, sqrt_n, ring_shift, stage_floats,
// noc_links_n, groups, group_cores, stage, item_stride (19 values).
// ``floats``: per_grant, log2n, flood_eps, cam_cycle_ns, e_match, e_mm,
// e_fixed, hop_ns, link_ns, hop_energy, chip_hop_ns, chip_link_ns,
// chip_hop_energy (13 values).
// ``chip_hops``/``chip_depth`` null: one chip; ``core_out`` null: no
// per-core output; ``group_start`` null: one block a (tick, lane), else
// the group form with its zeroed ``item_acc`` and (where its blocks do not
// hold their event buffers) ``spill``.
extern "C" int sparse_run_launch(
    int policy, const void* stream_frames, const void* ticks, const void* ptr,
    const void* src, const void* weight, const void* hops, const void* depth,
    const void* dest, const void* swept, const void* links,
    const void* chip_hops, const void* chip_depth, void* currents,
    void* table, void* acc, const void* acc0, void* done, void* core_out,
    const void* group_start, void* item_acc, void* spill, const int* ints,
    const float* floats, unsigned long long smem,
    void* stream) {
  RunArgs a;
  a.p = policy_args(ints[8], ints[9], ints[10], ints[11], ints[12],
                    floats[0], floats[1]);
  a.stream = static_cast<const uint8_t*>(stream_frames);
  a.ticks = static_cast<const int32_t*>(ticks);
  a.ptr = static_cast<const int32_t*>(ptr);
  a.src = static_cast<const int32_t*>(src);
  a.weight = static_cast<const float*>(weight);
  a.hops = static_cast<const int32_t*>(hops);
  a.depth = static_cast<const int32_t*>(depth);
  a.dest = static_cast<const int32_t*>(dest);
  a.swept = static_cast<const int32_t*>(swept);
  a.links = static_cast<const float*>(links);
  a.chip_hops = static_cast<const int32_t*>(chip_hops);
  a.chip_depth = static_cast<const int32_t*>(chip_depth);
  a.core_out = static_cast<float*>(core_out);
  a.currents = static_cast<float*>(currents);
  a.table = static_cast<float*>(table);
  a.acc = static_cast<float*>(acc);
  a.acc0 = static_cast<const float*>(acc0);
  a.done = static_cast<unsigned*>(done);
  a.group_start = static_cast<const int32_t*>(group_start);
  a.item_acc = static_cast<int*>(item_acc);
  a.spill = static_cast<int*>(spill);
  a.lanes = ints[0];
  a.ticks_total = ints[1];
  a.items = ints[2];
  a.cores = ints[3];
  a.links_n = ints[4];
  a.flood = ints[5];
  a.vec = ints[6];
  a.contrib_cap = ints[7];
  a.stage_floats = ints[13];
  a.noc_links_n = ints[14];
  a.groups = ints[15];
  a.group_cores = ints[16];
  a.stage = ints[17];
  a.item_stride = ints[18];
  a.flood_eps = floats[2];
  a.cam_cycle_ns = floats[3];
  a.e_match = floats[4];
  a.e_mm = floats[5];
  a.e_fixed = floats[6];
  a.hop_ns = floats[7];
  a.link_ns = floats[8];
  a.hop_energy = floats[9];
  a.chip_hop_ns = floats[10];
  a.chip_link_ns = floats[11];
  a.chip_hop_energy = floats[12];
  if ((a.chip_hops == nullptr) != (a.chip_depth == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.cores < 1 || a.lanes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.group_start != nullptr &&
      (a.groups < 1 || a.item_acc == nullptr ||
       (!(a.stage & kStageEvents) && a.spill == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = static_cast<size_t>(smem);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (policy) {
    case kBinaryTree: return launch_run<kBinaryTree>(a, bytes, s);
    case kGreedyTree: return launch_run<kGreedyTree>(a, bytes, s);
    case kTokenRing: return launch_run<kTokenRing>(a, bytes, s);
    case kHierRing: return launch_run<kHierRing>(a, bytes, s);
    case kHierTree: return launch_run<kHierTree>(a, bytes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
