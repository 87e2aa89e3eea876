// Sequential-in-time, parallel-in-voice IIR recurrences for Hopper (sm_90a).
//
// Holds the TPT state-variable lowpass for now; the LP18, biquad and allpass
// cascade scans of oscen_tpu/ops/pallas/iir.py join it as their slices land.
//
// tpt_svf_scan replaces oscen_tpu/ops/pallas/iir.py::tpt_svf_scan (the
// Zavalishin TPT SVF lowpass, reference filters/tpt/mod.rs:108-123) with the
// reference's per-sample op order:
//   high = (x - z0 * k - z1) * h;  band = high * g + z0;  low = band * g + z1;
//   z0 = high * g + band;          z1 = band * g + low;   y = low.
//
// Layout: one thread per voice lane; z0 and z1 stay in registers for the
// whole block.  x and y are time-major [B, V] (a warp's loads and stores of
// one time step are coalesced).  The coefficients h, g, k are either [V]
// rows, block-constant (time stride 0, loaded once), or [B, V] per-sample
// planes (time stride V): the caller passes each one's time stride.
//
// What bounds it on the card: the integrator chain is serial in time, about
// 9 dependent float ops per sample, and 256 voices are 8 warps for 132 SMs,
// so the kernel is bound by the latency of that chain.  It moves 8 bytes
// per sample and lane (20 with per-sample coefficients), far below the
// memory bound.  One warp per CUDA block spreads the warps over SMs; the
// unrolled time loop lets the loads run ahead of the chain.  The true block
// length B bounds the loop; any B >= 1 and any V work.
//
// Numerics: built with --fmad=false and without fast-math, so every product
// and sum rounds as PyTorch's separate elementwise ops do, and y, z0 and z1
// equal the plain PyTorch version bit for bit.  Denormals are kept
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

const char* oscen_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
