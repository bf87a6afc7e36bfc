// Fused leaky-integrate-and-fire update for Hopper (sm_90a).
//
// Replaces the TPU kernel `lif_step_pallas` (src/repro/kernels/lif_step/
// kernel.py:33, body `_lif_kernel`).  For every element of the (B, N)
// membrane state:
//   v_new = v * decay + I       one rounding: __fmaf_rn, written out
//   s     = v_new >= threshold  as 1.0f or 0.0f
//   v'    = s ? v_reset : v_new
// Both outputs are written in the same pass.
//
// Rounding.  The JAX reference rounds `v * decay + I` once: XLA contracts
// the multiply and the add into one FMA, in its jitted `impl="xla"` path as
// in the Pallas kernel.  The FMA is spelled out here so that the result does
// not rest on nvcc's -fmad default; the plain torch version
// (repro_torch/kernels/lif_step/ref.py) computes the same single rounding.
//
// Design.  The TPU kernel walks (8, 512) tiles through VMEM; an elementwise
// pass needs no tiles here.  The state is one flat array: each thread moves
// one float4 of v and of I in and one float4 of v' and of s out (16-byte
// loads and stores, neighbouring threads on neighbouring addresses), over a
// grid-stride loop.  When the element count is not a multiple of four, or a
// pointer is not 16-byte aligned, the scalar kernel takes the whole array.
//
// Bound.  Bytes: v and I in, v' and s out, 16 bytes an element; at the SNN
// path's (128, 4096) float32 that is 8,388,608 bytes, 2.50 us at 3.35 TB/s.
// Three floating-point operations an element are far below the float32 rate.
//
// bfloat16 (lif_step_bf16_launch).  JAX rounds twice on bfloat16, under both
// of its impls: the scalars are bfloat16 (the host rounds them before the
// launch), the product v * decay (exact in float32: two 8-bit significands)
// is rounded to bfloat16, and the sum is a float32 addition of the two
// bfloat16 values rounded to bfloat16.  Each step is spelled out (__fmul_rn,
// __float2bfloat16_rn, __fadd_rn) as the plain version computes it
// (ref.py, mul_add_bf16).  Each thread moves 16 bytes of v and of I in and
// of v' and s out: eight values.  Half the bytes of float32: 8 bytes an
// element.
//
// Interface: a plain C entry point (loaded with ctypes by
// repro_torch/kernels/lif_step/kernel.py); it launches on the given stream,
// does not synchronise, allocates nothing and returns the cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;     // 16 blocks per SM of the H100

struct Lif {
  float decay, threshold, reset;
  __device__ __forceinline__ void operator()(float v, float i, float* v_out,
                                             float* s_out) const {
    const float v_new = __fmaf_rn(v, decay, i);
    const bool fire = v_new >= threshold;
    *s_out = fire ? 1.0f : 0.0f;
    *v_out = fire ? reset : v_new;
  }
};

__global__ void __launch_bounds__(kThreads)
lif_step_vec4(const float4* __restrict__ v, const float4* __restrict__ cur,
              float4* __restrict__ v_out, float4* __restrict__ s_out,
              int64_t n4, Lif lif) {
  for (int64_t k = (int64_t)blockIdx.x * kThreads + threadIdx.x; k < n4;
       k += (int64_t)gridDim.x * kThreads) {
    const float4 a = v[k];
    const float4 b = cur[k];
    float4 vo, so;
    lif(a.x, b.x, &vo.x, &so.x);
    lif(a.y, b.y, &vo.y, &so.y);
    lif(a.z, b.z, &vo.z, &so.z);
    lif(a.w, b.w, &vo.w, &so.w);
    v_out[k] = vo;
    s_out[k] = so;
  }
}

__global__ void __launch_bounds__(kThreads)
lif_step_scalar(const float* __restrict__ v, const float* __restrict__ cur,
                float* __restrict__ v_out, float* __restrict__ s_out,
                int64_t n, Lif lif) {
  for (int64_t k = (int64_t)blockIdx.x * kThreads + threadIdx.x; k < n;
       k += (int64_t)gridDim.x * kThreads)
    lif(v[k], cur[k], &v_out[k], &s_out[k]);
}

struct LifBf16 {
  float decay, threshold;
  __nv_bfloat16 reset;
  __device__ __forceinline__ void operator()(__nv_bfloat16 v,
                                             __nv_bfloat16 i,
                                             __nv_bfloat16* v_out,
                                             __nv_bfloat16* s_out) const {
    const __nv_bfloat16 prod =
        __float2bfloat16_rn(__fmul_rn(__bfloat162float(v), decay));
    const __nv_bfloat16 v_new = __float2bfloat16_rn(
        __fadd_rn(__bfloat162float(prod), __bfloat162float(i)));
    const bool fire = __bfloat162float(v_new) >= threshold;
    *s_out = __float2bfloat16_rn(fire ? 1.0f : 0.0f);
    *v_out = fire ? reset : v_new;
  }
};

__global__ void __launch_bounds__(kThreads)
lif_step_bf16_vec8(const uint4* __restrict__ v, const uint4* __restrict__ cur,
                   uint4* __restrict__ v_out, uint4* __restrict__ s_out,
                   int64_t n8, LifBf16 lif) {
  for (int64_t k = (int64_t)blockIdx.x * kThreads + threadIdx.x; k < n8;
       k += (int64_t)gridDim.x * kThreads) {
    // eight bfloat16 values a 16-byte word
    const uint4 a = v[k];
    const uint4 b = cur[k];
    uint4 vo, so;
    const __nv_bfloat16* ah = reinterpret_cast<const __nv_bfloat16*>(&a);
    const __nv_bfloat16* bh = reinterpret_cast<const __nv_bfloat16*>(&b);
    __nv_bfloat16* voh = reinterpret_cast<__nv_bfloat16*>(&vo);
    __nv_bfloat16* soh = reinterpret_cast<__nv_bfloat16*>(&so);
#pragma unroll
    for (int j = 0; j < 8; ++j) lif(ah[j], bh[j], &voh[j], &soh[j]);
    v_out[k] = vo;
    s_out[k] = so;
  }
}

__global__ void __launch_bounds__(kThreads)
lif_step_bf16_scalar(const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ cur,
                     __nv_bfloat16* __restrict__ v_out,
                     __nv_bfloat16* __restrict__ s_out, int64_t n,
                     LifBf16 lif) {
  for (int64_t k = (int64_t)blockIdx.x * kThreads + threadIdx.x; k < n;
       k += (int64_t)gridDim.x * kThreads)
    lif(v[k], cur[k], &v_out[k], &s_out[k]);
}

int blocks_for(int64_t items) {
  const int64_t b = (items + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// n float32 elements of v and current -> v_next and spikes (n float32 each).
int lif_step_launch(const float* v, const float* current, float* v_out,
                    float* s_out, int64_t n, float decay, float threshold,
                    float v_reset, void* cuda_stream) {
  const cudaStream_t stream = static_cast<cudaStream_t>(cuda_stream);
  const Lif lif{decay, threshold, v_reset};
  if (n % 4 == 0 && aligned16(v) && aligned16(current) && aligned16(v_out) &&
      aligned16(s_out)) {
    const int64_t n4 = n / 4;
    lif_step_vec4<<<blocks_for(n4), kThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(v),
        reinterpret_cast<const float4*>(current),
        reinterpret_cast<float4*>(v_out), reinterpret_cast<float4*>(s_out),
        n4, lif);
  } else {
    lif_step_scalar<<<blocks_for(n), kThreads, 0, stream>>>(
        v, current, v_out, s_out, n, lif);
  }
  return cudaGetLastError();
}

// n bfloat16 elements of v and current -> v_next and spikes (n bfloat16
// each); decay, threshold and v_reset already rounded to bfloat16.
int lif_step_bf16_launch(const __nv_bfloat16* v, const __nv_bfloat16* current,
                         __nv_bfloat16* v_out, __nv_bfloat16* s_out,
                         int64_t n, float decay, float threshold,
                         float v_reset, void* cuda_stream) {
  const cudaStream_t stream = static_cast<cudaStream_t>(cuda_stream);
  const LifBf16 lif{decay, threshold, __float2bfloat16_rn(v_reset)};
  if (n % 8 == 0 && aligned16(v) && aligned16(current) && aligned16(v_out) &&
      aligned16(s_out)) {
    const int64_t n8 = n / 8;
    lif_step_bf16_vec8<<<blocks_for(n8), kThreads, 0, stream>>>(
        reinterpret_cast<const uint4*>(v),
        reinterpret_cast<const uint4*>(current),
        reinterpret_cast<uint4*>(v_out), reinterpret_cast<uint4*>(s_out), n8,
        lif);
  } else {
    lif_step_bf16_scalar<<<blocks_for(n), kThreads, 0, stream>>>(
        v, current, v_out, s_out, n, lif);
  }
  return cudaGetLastError();
}

}  // extern "C"
