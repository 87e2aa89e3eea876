// FM operator recurrences for Hopper (sm_90a).
//
// Replaces the four TPU kernels of oscen_tpu/ops/pallas/fm.py:
//   fract_phase3_kernel  <- fract_phase3 (_fract3_kernel): the three chain
//                           operators' phases, p += dt; p -= trunc(p);
//   chain3_kernel<false> <- fm_chain3_scan (_chain3_pipe_kernel): the
//                           fm-synth voice's operator chain op3 -> op2 -> op1
//                           with per-operator self-feedback and the route
//                           crossfade (FmOperatorChain.tick);
//   chain3_kernel<true>  <- pivot_chain3_scan (_pivot3_pipe_kernel): the
//                           pivot voice's chain, where the RAW sine is each
//                           operator's feedback and the enveloped signal
//                           drives the routing (PivotOperatorChain.tick);
//   fm_operator_kernel   <- fm_operator_scan (_kernel): one FM operator
//                           with feedback (FmOperator.tick).
//
// Layout: one thread per voice lane (per operator and voice lane for
// fract_phase3); phases and feedback carries stay in registers for the
// whole block.  Streams are time-major [B, V], so a warp's loads and stores
// of one time step are 32 neighbouring floats.  The chain's dt is either
// per-sample [3, B, V] (the pitch steps mid-block at a note-on) or
// block-constant [3, 1, V]: the caller passes its time stride (V or 0).
// The chains fold each operator's level into its envelope stream before the
// launch (oscen_tpu_torch/ops/cuda/fm.py), as the JAX package does.
//
// The TPU kernels software-pipeline the chain (op3 at sample i, op2 at i-1,
// op1 at i-2 as one stacked vector op, with activity masks while the
// pipeline fills and drains).  That is a vector-unit device; here each
// thread runs the three operators in tick order within a sample, and the
// unrolled time loop lets the compiler overlap one sample's op3 with the
// previous sample's op1.
//
// What bounds it on the card: each operator is a dependent chain of ~14
// float ops (the sine polynomial, the feedback product, the wrap) per
// sample, serial in time; 256 voices are 8 warps for 132 SMs.  The chains
// move 16 bytes per sample and lane (20 with per-sample dt), far below the
// memory bound, so the kernels are bound by the latency of that chain.  One
// warp per CUDA block spreads the warps over SMs.  The true block length B
// bounds every loop and the carries hold the last real sample; any B >= 1
// and any V work.
//
// Numerics: built with --fmad=false and without fast-math, so every product
// and sum rounds as PyTorch's separate elementwise ops do, and every output
// equals the plain PyTorch version bit for bit.  The sine rounds half to
// even (rintf, as torch.round; roundf would round half away from zero).
// The FM wrap is p - truncf(p), Rust's .fract(), not the oscillators'
// floorf.  Each operator keeps the JAX package's association:
//   chains:   y = sin_turns((ph + pm) + prev * fb) * (env * lvl)
//   operator: y = sin_turns(ph + (pm + prev * fb)) * env * lvl
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

// float32 roundings of oscen_tpu/ops/fastmath.py SIN_TURNS_COEFFS
constexpr float kC0 = 0x1.921dfep+2f;
constexpr float kC1 = -0x1.4aa97ap+5f;
constexpr float kC2 = 0x1.45912ep+6f;
constexpr float kC3 = -0x1.2a8046p+6f;
constexpr float kC4 = 0x1.08897cp+5f;

// sin(2*pi*x) for x in turns: the JAX package's degree-9 odd polynomial
__device__ __forceinline__ float sin_turns(float x) {
  const float w = x - rintf(x);
  const float u = w * w;
  float acc = u * kC4;
  acc = acc + kC3;
  acc = acc * u + kC2;
  acc = acc * u + kC1;
  acc = acc * u + kC0;
  return acc * w;
}

__device__ __forceinline__ float fract_step(float p, float dt) {
  p = p + dt;
  return p - truncf(p);  // Rust .fract()
}

__global__ void __launch_bounds__(kThreads)
fract_phase3_kernel(const float* __restrict__ phases,
                    const float* __restrict__ dt, float* __restrict__ out,
                    float* __restrict__ carry, int V, int B) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 3 * V) return;
  const int r = i / V;
  const int v = i - r * V;
  float p = phases[i];
  const float d = dt[i];
  float* o = out + (size_t)r * B * V + v;
#pragma unroll 8
  for (int t = 0; t < B; ++t) {
    o[(size_t)t * V] = p;
    p = fract_step(p, d);
  }
  carry[i] = p;
}

template <bool kPivot>
__global__ void __launch_bounds__(kThreads)
chain3_kernel(const float* __restrict__ phases,
              const float* __restrict__ prevs, const float* __restrict__ dt,
              const float* __restrict__ fb, const float* __restrict__ mix,
              const float* __restrict__ e3, const float* __restrict__ e2,
              const float* __restrict__ e1, float* __restrict__ y,
              float* __restrict__ ph_out, float* __restrict__ pv_out, int V,
              int B, int dt_stride) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  float ph3 = phases[v], ph2 = phases[V + v], ph1 = phases[2 * V + v];
  float p3 = prevs[v], p2 = prevs[V + v], p1 = prevs[2 * V + v];
  const float fb3 = fb[v], fb2 = fb[V + v], fb1 = fb[2 * V + v];
  const float m = mix[v];
  const float om = 1.0f - m;
  const size_t dplane = (size_t)(dt_stride ? B : 1) * V;
  const float* d3 = dt + v;
  const float* d2 = d3 + dplane;
  const float* d1 = d2 + dplane;
#pragma unroll 4
  for (int t = 0; t < B; ++t) {
    const size_t i = (size_t)t * V + v;
    const size_t di = (size_t)t * dt_stride;
    // op3: no phase modulation
    const float s3 = sin_turns(ph3 + p3 * fb3);
    float a, b;
    if (kPivot) {
      const float a3 = s3 * e3[i];
      a = a3 * om;
      b = a3 * m;
      p3 = s3;
    } else {
      const float y3 = s3 * e3[i];
      a = y3 * om;
      b = y3 * m;
      p3 = y3;
    }
    ph3 = fract_step(ph3, d3[di]);
    // op2, modulated by the route's a side
    const float s2 = sin_turns((ph2 + a) + p2 * fb2);
    float pm1;
    if (kPivot) {
      pm1 = s2 * e2[i] + b;
      p2 = s2;
    } else {
      const float y2 = s2 * e2[i];
      pm1 = y2 + b;
      p2 = y2;
    }
    ph2 = fract_step(ph2, d2[di]);
    // op1, the carrier, modulated by op2 plus the route's b side
    const float s1 = sin_turns((ph1 + pm1) + p1 * fb1);
    const float y1 = s1 * e1[i];
    p1 = kPivot ? s1 : y1;
    y[i] = y1;
    ph1 = fract_step(ph1, d1[di]);
  }
  ph_out[v] = ph3;
  ph_out[V + v] = ph2;
  ph_out[2 * V + v] = ph1;
  pv_out[v] = p3;
  pv_out[V + v] = p2;
  pv_out[2 * V + v] = p1;
}

__global__ void __launch_bounds__(kThreads)
fm_operator_kernel(const float* __restrict__ phase0,
                   const float* __restrict__ prev0,
                   const float* __restrict__ dt, const float* __restrict__ pm,
                   const float* __restrict__ fb,
                   const float* __restrict__ env,
                   const float* __restrict__ lvl, float* __restrict__ y,
                   float* __restrict__ phase_out,
                   float* __restrict__ prev_out, int V, int B) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  float ph = phase0[v];
  float prev = prev0[v];
#pragma unroll 4
  for (int t = 0; t < B; ++t) {
    const size_t i = (size_t)t * V + v;
    const float total_pm = pm[i] + prev * fb[i];
    const float out = sin_turns(ph + total_pm) * env[i] * lvl[i];
    ph = fract_step(ph, dt[i]);
    prev = out;
    y[i] = out;
  }
  phase_out[v] = ph;
  prev_out[v] = prev;
}

template <bool kPivot>
int launch_chain3(const float* phases, const float* prevs, const float* dt,
                  const float* fb, const float* mix, const float* e3,
                  const float* e2, const float* e1, float* y, float* ph_out,
                  float* pv_out, int V, int B, int dt_stride, void* stream) {
  if (V < 1 || B < 1 || (dt_stride != 0 && dt_stride != V))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((V + kThreads - 1) / kThreads);
  chain3_kernel<kPivot><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      phases, prevs, dt, fb, mix, e3, e2, e1, y, ph_out, pv_out, V, B,
      dt_stride);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// phases, dt [3, V] -> out [3, B, V] (pre-increment phases), carry [3, V].
int oscen_fract_phase3(const float* phases, const float* dt, float* out,
                       float* carry, int V, int B, void* stream) {
  if (V < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((3 * V + kThreads - 1) / kThreads);
  fract_phase3_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      phases, dt, out, carry, V, B);
  return (int)cudaGetLastError();
}

// phases, prevs, fb [3, V]; dt [3, B, V] (dt_stride V) or [3, 1, V]
// (dt_stride 0); mix [V]; e3, e2, e1 [B, V] (level-folded envelopes)
// -> y [B, V], phases' and prevs' [3, V].
int oscen_fm_chain3_scan(const float* phases, const float* prevs,
                         const float* dt, const float* fb, const float* mix,
                         const float* e3, const float* e2, const float* e1,
                         float* y, float* ph_out, float* pv_out, int V, int B,
                         int dt_stride, void* stream) {
  return launch_chain3<false>(phases, prevs, dt, fb, mix, e3, e2, e1, y,
                              ph_out, pv_out, V, B, dt_stride, stream);
}

// as oscen_fm_chain3_scan; prevs carry the raw sines.
int oscen_pivot_chain3_scan(const float* phases, const float* prevs,
                            const float* dt, const float* fb,
                            const float* mix, const float* e3,
                            const float* e2, const float* e1, float* y,
                            float* ph_out, float* pv_out, int V, int B,
                            int dt_stride, void* stream) {
  return launch_chain3<true>(phases, prevs, dt, fb, mix, e3, e2, e1, y,
                             ph_out, pv_out, V, B, dt_stride, stream);
}

// phase0, prev0 [V]; dt, pm, fb, env, lvl [B, V] -> y [B, V], phase',
// prev' [V].
int oscen_fm_operator_scan(const float* phase0, const float* prev0,
                           const float* dt, const float* pm, const float* fb,
                           const float* env, const float* lvl, float* y,
                           float* phase_out, float* prev_out, int V, int B,
                           void* stream) {
  if (V < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((V + kThreads - 1) / kThreads);
  fm_operator_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      phase0, prev0, dt, pm, fb, env, lvl, y, phase_out, prev_out, V, B);
  return (int)cudaGetLastError();
}

const char* oscen_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
