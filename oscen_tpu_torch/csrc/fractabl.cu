// Store-layout ablations of fract_phase3 (K17) for Hopper (sm_90a).
//
// Replaces the TPU kernels of the fract-phase ablation tools:
//   LAYOUT 0 direct <- tools/fractabl2.py:81 (_direct_kernel :69): one store
//                      of the whole [3, V] plane per step into [B, 3, V];
//   LAYOUT 1 packed <- tools/fractabl.py:67 (_packed_kernel :50): the
//                      [3, 256] plane packed as [6, 128] (one vreg tile),
//                      output [B * 6, 128];
//   LAYOUT 2 seg    <- tools/fractabl2.py:135 (_seg_kernel :99): phase A
//                      sweeps the recurrence storing only the S = 8 segment
//                      boundaries, phase B replays the S segments in
//                      parallel into a j-major [SEG, 3 * S, V] output.
// All three compute fract_phase3 (oscen_tpu/ops/pallas/fm.py:199, the
// port's fract_phase3_kernel in csrc/fm.cu, K12): p += dt; p -= trunc(p),
// the phase before each increment stored, the carry after B steps.
//
// What bounds it on the card: one dependent add-wrap per step and lane,
// serial in time; 3V = 768 lanes are 24 warps for 132 SMs.  The stores are
// 4 bytes per step and lane (3 MB at B = 1024), a few microseconds at 3.35
// TB/s, so each layout is bound by the latency of the chain, as K12 is.
//
// Every layout steps as K12 does since its redesign: a lane whose p0 and
// dt both lie in [+0, 1) (checked once, on their bits: the sign clear and
// below 1.0f) keeps every q = p + dt in [+0, 2) for the whole block, and
// there q - truncf(q) is short_wrap.cuh's q - (q >= 1), FADD -> FSET ->
// FADD; every other lane (negative, -0.0, >= 1, inf, NaN) steps by the
// reference's truncf.  A warp whose lanes disagree runs both loops.  So
// each layout prices its store layout against K12's body alone:
//  - direct: one thread per (operator, voice) lane, 32 threads a block, a
//    warp's stores of one step are 32 neighbouring floats of the [B, 3, V]
//    output: K12's design with its [3, B, V] output turned into [B, 3, V];
//  - packed: the [6, 128] sublane packing has no meaning on Hopper (a warp
//    is 32 lanes of one register each); its nearest analogue is two voices
//    per thread with float2 loads and stores, half the threads, each with
//    two independent chains to interleave, each lane's wrap chosen apart
//    (four loops, one per pair of choices).  The output memory order is
//    the tool's [B * 6, 128], i.e. [B, 3, V];
//  - seg: a block of 32 lanes x S threads.  Phase A: the first warp
//    sweeps (S - 1) * SEG steps per lane and writes the S boundary states
//    to shared memory; __syncthreads; phase B: S threads per lane replay
//    SEG steps each, S times the parallel chains of direct.  A lane's
//    boundaries stay in [+0, 1) when its p0 and dt do, so both phases take
//    the lane's one choice.
//
// Numerics: built with --fmad=false and without fast-math; every layout
// runs the same float values in the same order per lane, so every output is
// bit-equal to fract_phase3 and to the plain PyTorch versions
// (oscen_tpu_torch/ops/cuda/fractabl.py), which step by truncf throughout:
// the short wrap is that value on its domain.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include "short_wrap.cuh"

namespace {

constexpr int kSegments = 8;  // S of tools/fractabl2.py
constexpr int kLanesPerBlock = 32;

// One step: q = p + dt, then the wrap (the short one on the lane's domain)
template <bool SHORT>
__device__ __forceinline__ float fract_step(float p, float dt) {
  const float q = p + dt;
  if constexpr (SHORT)
    return oscen_wrap::short_wrap(q);
  else
    return q - truncf(q);  // Rust .fract(), never floorf
}

// Whether x lies in [+0, 1), on its bits: the sign clear and below 1.0f.
__device__ __forceinline__ bool in_unit(float x) {
  return __float_as_uint(x) < 0x3F800000u;
}

// Whether a lane takes the short wrap for the whole block (K12's rule)
__device__ __forceinline__ bool short_lane(float p0, float dt) {
  return in_unit(p0) && in_unit(dt);
}

// direct: n steps of one lane from p, stored every `stride` floats
template <bool SHORT>
__device__ __forceinline__ float run_lane(float p, float d, float* o,
                                          size_t stride, int n) {
#pragma unroll 8
  for (int t = 0; t < n; ++t) {
    o[(size_t)t * stride] = p;
    p = fract_step<SHORT>(p, d);
  }
  return p;
}

// packed: n steps of two lanes, one float2 store a step
template <bool SX, bool SY>
__device__ __forceinline__ float2 run_pair(float2 p, float2 d, float2* o,
                                           size_t stride, int n) {
#pragma unroll 8
  for (int t = 0; t < n; ++t) {
    o[(size_t)t * stride] = p;
    p.x = fract_step<SX>(p.x, d.x);
    p.y = fract_step<SY>(p.y, d.y);
  }
  return p;
}

// seg, phase A: n steps of one lane, no stores
template <bool SHORT>
__device__ __forceinline__ float sweep(float p, float d, int n) {
#pragma unroll 8
  for (int t = 0; t < n; ++t) p = fract_step<SHORT>(p, d);
  return p;
}

template <int LAYOUT>
__global__ void fract_abl_kernel(const float* __restrict__ phases,
                                 const float* __restrict__ dt,
                                 float* __restrict__ out,
                                 float* __restrict__ carry, int V, int B) {
  if constexpr (LAYOUT == 0) {
    // direct: o[t, k, v], lane i = k * V + v
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= 3 * V) return;
    const float p = phases[i];
    const float d = dt[i];
    const size_t stride = (size_t)3 * V;
    carry[i] = short_lane(p, d) ? run_lane<true>(p, d, out + i, stride, B)
                                : run_lane<false>(p, d, out + i, stride, B);
  } else if constexpr (LAYOUT == 1) {
    // packed: two neighbouring voices of one operator per thread (V even)
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int half = 3 * V / 2;
    if (i >= half) return;
    const float2 p = reinterpret_cast<const float2*>(phases)[i];
    const float2 d = reinterpret_cast<const float2*>(dt)[i];
    float2* o = reinterpret_cast<float2*>(out) + i;
    const bool sx = short_lane(p.x, d.x), sy = short_lane(p.y, d.y);
    float2 c;
    if (sx && sy)
      c = run_pair<true, true>(p, d, o, half, B);
    else if (sx)
      c = run_pair<true, false>(p, d, o, half, B);
    else if (sy)
      c = run_pair<false, true>(p, d, o, half, B);
    else
      c = run_pair<false, false>(p, d, o, half, B);
    reinterpret_cast<float2*>(carry)[i] = c;
  } else {
    // seg: thread (s, l) of the block; lane i = k * V + v
    __shared__ float bounds[kSegments][kLanesPerBlock];
    const int l = threadIdx.x % kLanesPerBlock;
    const int s = threadIdx.x / kLanesPerBlock;
    const int i = blockIdx.x * kLanesPerBlock + l;
    const bool live = i < 3 * V;
    const int seg = B / kSegments;
    const float p0 = live ? phases[i] : 0.f;
    const float d = live ? dt[i] : 0.f;
    const bool fast = short_lane(p0, d);
    if (s == 0) {
      // phase A: the boundary sweep, no stores to device memory
      float p = p0;
      bounds[0][l] = p;
      for (int b = 1; b < kSegments; ++b) {
        p = fast ? sweep<true>(p, d, seg) : sweep<false>(p, d, seg);
        bounds[b][l] = p;
      }
    }
    __syncthreads();
    if (!live) return;
    // phase B: segment s from its boundary, rows k * S + s of [SEG, 3S, V]
    const int k = i / V;
    const int v = i - k * V;
    float* o = out + (size_t)(k * kSegments + s) * V + v;
    const size_t stride = (size_t)3 * kSegments * V;
    const float p = bounds[s][l];
    const float c = fast ? run_lane<true>(p, d, o, stride, seg)
                         : run_lane<false>(p, d, o, stride, seg);
    if (s == kSegments - 1) carry[i] = c;
  }
}

}  // namespace

extern "C" {

// phases, dt [3, V] (op3, op2, op1) -> carry [3, V] and out: [B, 3, V]
// (layout 0 direct, 1 packed; packed needs V even) or [B / 8, 3 * 8, V]
// (layout 2 seg, j-major: row k * 8 + s of step j is operator k at time
// s * B / 8 + j; B a multiple of 8).
int oscen_fract_abl(const float* phases, const float* dt, float* out,
                    float* carry, int layout, int V, int B, void* stream) {
  if (V < 1 || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (layout) {
    case 0:
      fract_abl_kernel<0><<<(3 * V + 31) / 32, 32, 0, st>>>(phases, dt, out,
                                                            carry, V, B);
      break;
    case 1:
      if (V % 2) return (int)cudaErrorInvalidValue;
      fract_abl_kernel<1><<<(3 * V / 2 + 31) / 32, 32, 0, st>>>(
          phases, dt, out, carry, V, B);
      break;
    case 2:
      if (B % kSegments) return (int)cudaErrorInvalidValue;
      fract_abl_kernel<2><<<(3 * V + kLanesPerBlock - 1) / kLanesPerBlock,
                            kLanesPerBlock * kSegments, 0, st>>>(
          phases, dt, out, carry, V, B);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* oscen_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
