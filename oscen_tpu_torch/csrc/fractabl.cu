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
// port's fract_phase3_kernel in csrc/fm.cu): p += dt; p -= trunc(p), the
// phase before each increment stored, the carry after B steps.
//
// What bounds it on the card: one dependent add-trunc-subtract per step
// and lane, serial in time; 3V = 768 lanes are 24 warps for 132 SMs.  The
// stores are 4 bytes per step and lane (3 MB at B = 1024), a few
// microseconds at 3.35 TB/s, so each layout is bound by the latency of the
// chain, as K12 is.  What each design does about it:
//  - direct: one thread per (operator, voice) lane, a warp's stores of one
//    step are 32 neighbouring floats of the [B, 3, V] output;
//  - packed: the [6, 128] sublane packing has no meaning on Hopper (a warp
//    is 32 lanes of one register each); its nearest analogue is two voices
//    per thread with float2 loads and stores, half the threads, each with
//    two independent chains to interleave.  The output memory order is
//    the tool's [B * 6, 128], i.e. [B, 3, V];
//  - seg: a block of 32 lanes x S threads.  Phase A: the first warp
//    sweeps (S - 1) * SEG steps per lane and writes the S boundary states
//    to shared memory; __syncthreads; phase B: S threads per lane replay
//    SEG steps each, S times the parallel chains of direct.
//
// Numerics: built with --fmad=false and without fast-math; every layout
// runs the same float ops in the same order per lane, so every output is
// bit-equal to fract_phase3 and to the plain PyTorch versions
// (oscen_tpu_torch/ops/cuda/fractabl.py).
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int kSegments = 8;  // S of tools/fractabl2.py
constexpr int kLanesPerBlock = 32;

__device__ __forceinline__ float fract_step(float p, float dt) {
  p = p + dt;
  return p - truncf(p);  // Rust .fract(), never floorf
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
    float p = phases[i];
    const float d = dt[i];
    float* o = out + i;
#pragma unroll 8
    for (int t = 0; t < B; ++t) {
      o[(size_t)t * 3 * V] = p;
      p = fract_step(p, d);
    }
    carry[i] = p;
  } else if constexpr (LAYOUT == 1) {
    // packed: two neighbouring voices of one operator per thread (V even)
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int half = 3 * V / 2;
    if (i >= half) return;
    float2 p = reinterpret_cast<const float2*>(phases)[i];
    const float2 d = reinterpret_cast<const float2*>(dt)[i];
    float2* o = reinterpret_cast<float2*>(out) + i;
#pragma unroll 8
    for (int t = 0; t < B; ++t) {
      o[(size_t)t * half] = p;
      p.x = fract_step(p.x, d.x);
      p.y = fract_step(p.y, d.y);
    }
    reinterpret_cast<float2*>(carry)[i] = p;
  } else {
    // seg: thread (s, l) of the block; lane i = k * V + v
    __shared__ float bounds[kSegments][kLanesPerBlock];
    const int l = threadIdx.x % kLanesPerBlock;
    const int s = threadIdx.x / kLanesPerBlock;
    const int i = blockIdx.x * kLanesPerBlock + l;
    const bool live = i < 3 * V;
    const int seg = B / kSegments;
    const float d = live ? dt[i] : 0.f;
    if (s == 0) {
      // phase A: the boundary sweep, no stores to device memory
      float p = live ? phases[i] : 0.f;
      bounds[0][l] = p;
      for (int b = 1; b < kSegments; ++b) {
#pragma unroll 8
        for (int t = 0; t < seg; ++t) p = fract_step(p, d);
        bounds[b][l] = p;
      }
    }
    __syncthreads();
    if (!live) return;
    // phase B: segment s from its boundary, rows k * S + s of [SEG, 3S, V]
    const int k = i / V;
    const int v = i - k * V;
    float p = bounds[s][l];
    float* o = out + (size_t)(k * kSegments + s) * V + v;
    const size_t stride = (size_t)3 * kSegments * V;
#pragma unroll 8
    for (int j = 0; j < seg; ++j) {
      o[j * stride] = p;
      p = fract_step(p, d);
    }
    if (s == kSegments - 1) carry[i] = p;
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
