// Sequential-in-time, parallel-in-voice IIR recurrences for Hopper (sm_90a).
//
// Four kernels, each replacing one of oscen_tpu/ops/pallas/iir.py with the
// reference's per-sample op order (so every output is bit-identical across
// block sizes):
//
// tpt_svf_kernel replaces tpt_svf_scan (_tpt_kernel; the Zavalishin TPT SVF
// lowpass, reference filters/tpt/mod.rs:108-123):
//   high = (x - z0 * k - z1) * h;  band = high * g + z0;  low = band * g + z1;
//   z0 = high * g + band;          z1 = band * g + low;   y = low.
//
// lp18_kernel replaces lp18_scan (_lp18_kernel; the three-pole LP18 of
// nih-twin-peaks/src/lp18_filter.rs, a tanh-saturated first pole):
//   hp = (x - h * z0 - z1 - z2) / (1 + g);  bp1 = g * hp + z0;
//   z0 = tanh(bp1);  bp2 = g * bp1 + z1;  z1 = bp2;  z2 = y = g * bp2 + z2.
// The tanh is evaluated in double and rounded once, (float)tanh((double)b),
// the correctly rounded float32 value that ops/fmath.py::tanh gives on the
// CPU and on the card: float32 tanh differs between PyTorch's CPU and CUDA
// builds.  The quotient is a true IEEE division (nvcc's default
// -prec-div=true; no fast-math).
//
// biquad_kernel replaces biquad_scan (_biquad_kernel; the DF-II-T biquad of
// iir_lowpass/mod.rs:109-132):
//   out = b0 * x + v1;  v1 = b1 * x - a1 * out + v2;  v2 = b2 * x - a2 * out.
// It also applies the reference tick's denormal snaps: |x|, |v1| and |v2|
// below 1e-15 become 0 (the Pallas kernel leaves them out because the TPU
// flushes denormals; the JAX package's CPU scan keeps them, and so do the
// kernel and its plain version here).
//
// allpass_kernel replaces allpass_cascade_scan (_allpass_kernel; the branch of
// the IIR-halfband resampler, resample/halfband_iir.rs:24-63): S first-order
// allpasses chained within the sample, per stage
//   y = a[s] * (x - yp[s]) + xp[s];  xp[s] = x;  yp[s] = y;  x = y.
// The coefficients and both histories of every stage stay in registers (S is
// a template parameter, 1 to 8). The wrapper may put both branches of one
// halfband stage side by side as lanes, each with its own betas in a [S, V].
//
// Layout: one thread per voice lane; the filter state stays in registers
// for the whole block.  x and y are time-major [B, V] (a warp's loads and
// stores of one time step are coalesced).  Every coefficient is either a
// [V] row, block-constant (time stride 0, loaded once), or a [B, V]
// per-sample plane (time stride V): the caller passes each one's time
// stride, so one kernel serves both forms.
//
// What bounds them on the card: each recurrence is serial in time (about
// 9 dependent float ops per sample for the TPT and the biquad, 13 plus a
// double-precision tanh for the LP18, 3 * S for the allpass cascade), and
// 256 voices are 8 warps for 132 SMs; the twin-peaks filter is 1 or 2 lanes
// of one warp, the oversampled saturator's resampler 2 (one per branch).  So
// every kernel is bound by the latency of that chain.  They move 8 bytes per sample and
// lane (up to 28 with per-sample coefficients), far below the 3.35 TB/s
// memory bound.  One warp per CUDA block spreads the warps over SMs; the
// unrolled time loop lets the loads run ahead of the chain.  The true block
// length B bounds the loop; any B >= 1 and any V work.
//
// Numerics: built with --fmad=false and without fast-math, so every product
// and sum rounds as PyTorch's separate elementwise ops do, and every output
// equals the plain PyTorch version bit for bit.  Denormals are kept
// (nvcc's default -ftz=false), as on the CPU; the TPU flushed them.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
tpt_svf_kernel(const float* __restrict__ x, const float* __restrict__ h,
               const float* __restrict__ g, const float* __restrict__ k,
               const float* __restrict__ z0_in,
               const float* __restrict__ z1_in, float* __restrict__ y,
               float* __restrict__ z0_out, float* __restrict__ z1_out,
               int V, int B, int hs, int gs, int ks) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  float z0 = z0_in[v];
  float z1 = z1_in[v];
#pragma unroll 4
  for (int t = 0; t < B; ++t) {
    const size_t i = (size_t)t * V + v;
    const float xt = x[i];
    const float ht = h[(size_t)t * hs + v];
    const float gt = g[(size_t)t * gs + v];
    const float kt = k[(size_t)t * ks + v];
    const float high = (xt - z0 * kt - z1) * ht;
    const float band = high * gt + z0;
    const float low = band * gt + z1;
    z0 = high * gt + band;
    z1 = band * gt + low;
    y[i] = low;
  }
  z0_out[v] = z0;
  z1_out[v] = z1;
}

__global__ void __launch_bounds__(kThreads)
lp18_kernel(const float* __restrict__ x, const float* __restrict__ g,
            const float* __restrict__ h, const float* __restrict__ z_in,
            float* __restrict__ y, float* __restrict__ z_out, int V, int B,
            int gs, int hs) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  float z0 = z_in[v];
  float z1 = z_in[V + v];
  float z2 = z_in[2 * V + v];
#pragma unroll 4
  for (int t = 0; t < B; ++t) {
    const size_t i = (size_t)t * V + v;
    const float xt = x[i];
    const float gt = g[(size_t)t * gs + v];
    const float ht = h[(size_t)t * hs + v];
    const float hp = (xt - ht * z0 - z1 - z2) / (1.0f + gt);
    const float bp1 = gt * hp + z0;
    z0 = (float)tanh((double)bp1);
    const float bp2 = gt * bp1 + z1;
    z1 = bp2;
    z2 = gt * bp2 + z2;
    y[i] = z2;
  }
  z_out[v] = z0;
  z_out[V + v] = z1;
  z_out[2 * V + v] = z2;
}

__device__ __forceinline__ float snap(float v) {
  return fabsf(v) < 1e-15f ? 0.0f : v;
}

__global__ void __launch_bounds__(kThreads)
biquad_kernel(const float* __restrict__ x, const float* __restrict__ b0,
              const float* __restrict__ b1, const float* __restrict__ b2,
              const float* __restrict__ a1, const float* __restrict__ a2,
              const float* __restrict__ v1_in,
              const float* __restrict__ v2_in, float* __restrict__ y,
              float* __restrict__ v1_out, float* __restrict__ v2_out, int V,
              int B, int b0s, int b1s, int b2s, int a1s, int a2s) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  float v1 = v1_in[v];
  float v2 = v2_in[v];
#pragma unroll 4
  for (int t = 0; t < B; ++t) {
    const size_t i = (size_t)t * V + v;
    const float xt = snap(x[i]);
    const float c0 = b0[(size_t)t * b0s + v];
    const float c1 = b1[(size_t)t * b1s + v];
    const float c2 = b2[(size_t)t * b2s + v];
    const float d1 = a1[(size_t)t * a1s + v];
    const float d2 = a2[(size_t)t * a2s + v];
    const float out = c0 * xt + v1;
    const float nv1 = c1 * xt - d1 * out + v2;
    v2 = snap(c2 * xt - d2 * out);
    v1 = snap(nv1);
    y[i] = out;
  }
  v1_out[v] = v1;
  v2_out[v] = v2;
}

template <int S>
__global__ void __launch_bounds__(kThreads)
allpass_kernel(const float* __restrict__ x, const float* __restrict__ a,
               const float* __restrict__ xp_in,
               const float* __restrict__ yp_in, float* __restrict__ y,
               float* __restrict__ xp_out, float* __restrict__ yp_out, int V,
               int B) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  float c[S], xp[S], yp[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    c[s] = a[s * V + v];
    xp[s] = xp_in[s * V + v];
    yp[s] = yp_in[s * V + v];
  }
#pragma unroll 4
  for (int t = 0; t < B; ++t) {
    const size_t i = (size_t)t * V + v;
    float cur = x[i];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float out = c[s] * (cur - yp[s]) + xp[s];
      xp[s] = cur;
      yp[s] = out;
      cur = out;
    }
    y[i] = cur;
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    xp_out[s * V + v] = xp[s];
    yp_out[s * V + v] = yp[s];
  }
}

template <int S>
void launch_allpass(const float* x, const float* a, const float* xp,
                    const float* yp, float* y, float* xp_out, float* yp_out,
                    int V, int B, cudaStream_t stream) {
  const dim3 grid((V + kThreads - 1) / kThreads);
  allpass_kernel<S><<<grid, kThreads, 0, stream>>>(x, a, xp, yp, y, xp_out,
                                                    yp_out, V, B);
}

}  // namespace

extern "C" {

// x [B, V]; h, g, k [V] (time stride 0) or [B, V] (time stride V);
// z0, z1 [V] -> y [B, V], z0', z1' [V].
int oscen_tpt_svf_scan(const float* x, const float* h, const float* g,
                       const float* k, const float* z0, const float* z1,
                       float* y, float* z0_out, float* z1_out, int V, int B,
                       int h_stride, int g_stride, int k_stride,
                       void* stream) {
  if (V < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((V + kThreads - 1) / kThreads);
  tpt_svf_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, h, g, k, z0, z1, y, z0_out, z1_out, V, B, h_stride, g_stride,
      k_stride);
  return (int)cudaGetLastError();
}

// x [B, V]; g, h [V] (time stride 0) or [B, V] (time stride V); z [3, V]
// -> y [B, V], z' [3, V].
int oscen_lp18_scan(const float* x, const float* g, const float* h,
                    const float* z, float* y, float* z_out, int V, int B,
                    int g_stride, int h_stride, void* stream) {
  if (V < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((V + kThreads - 1) / kThreads);
  lp18_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, g, h, z, y, z_out, V, B, g_stride, h_stride);
  return (int)cudaGetLastError();
}

// x [B, V]; b0, b1, b2, a1, a2 [V] (time stride 0) or [B, V] (time stride
// V); v1, v2 [V] -> y [B, V], v1', v2' [V].
int oscen_biquad_scan(const float* x, const float* b0, const float* b1,
                      const float* b2, const float* a1, const float* a2,
                      const float* v1, const float* v2, float* y,
                      float* v1_out, float* v2_out, int V, int B,
                      int b0_stride, int b1_stride, int b2_stride,
                      int a1_stride, int a2_stride, void* stream) {
  if (V < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((V + kThreads - 1) / kThreads);
  biquad_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, b0, b1, b2, a1, a2, v1, v2, y, v1_out, v2_out, V, B, b0_stride,
      b1_stride, b2_stride, a1_stride, a2_stride);
  return (int)cudaGetLastError();
}

// x [B, V]; a, xp, yp [S, V] (stage-major) -> y [B, V], xp', yp' [S, V];
// 1 <= S <= 8.
int oscen_allpass_cascade_scan(const float* x, const float* a,
                               const float* xp, const float* yp, float* y,
                               float* xp_out, float* yp_out, int V, int B,
                               int S, void* stream) {
  if (V < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (S) {
#define OSCEN_ALLPASS_CASE(n)                                             \
  case n:                                                                 \
    launch_allpass<n>(x, a, xp, yp, y, xp_out, yp_out, V, B, st);         \
    break;
    OSCEN_ALLPASS_CASE(1)
    OSCEN_ALLPASS_CASE(2)
    OSCEN_ALLPASS_CASE(3)
    OSCEN_ALLPASS_CASE(4)
    OSCEN_ALLPASS_CASE(5)
    OSCEN_ALLPASS_CASE(6)
    OSCEN_ALLPASS_CASE(7)
    OSCEN_ALLPASS_CASE(8)
#undef OSCEN_ALLPASS_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* oscen_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
