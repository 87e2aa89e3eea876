// Exact sequential phase accumulation for Hopper (sm_90a).
//
// Replaces the TPU kernel oscen_tpu/ops/pallas/phase.py::phase_scan: for
// every voice lane, out[t] = p; p = p + dt[t]; p = p - floor(p), the
// reference's per-sample rem_euclid(1.0) wrap in its exact op order.
//
// Layout: one thread per voice lane; the phase stays in a register for the
// whole block.  dt and the output are time-major [B, V], so the 32 lanes of
// a warp load and store 32 neighbouring floats per time step (coalesced).
//
// What bounds it on the card: the add-floor-subtract chain is serial in
// time, ~3 dependent float ops per sample, and the flagship has V = 256
// voices, i.e. 256 threads: 8 warps for 132 SMs.  It moves 8 bytes per
// sample and lane, so it is bound by the latency of the chain (and of the
// first loads), not by bytes or issue rate.  The design keeps one warp per
// CUDA block, so the warps spread over 8 SMs instead of sharing one, and
// unrolls the time loop so that the loads of dt run ahead of the chain.
// The true block length B bounds the loop; any B >= 1 and any V work.
//
// Numerics: built with --fmad=false and without fast-math; floorf and the
// two IEEE operations round as PyTorch's elementwise ops do, so the output
// and the carry equal the plain PyTorch version bit for bit.  The wrap is
// p - floorf(p) (rem_euclid), never truncf.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
phase_scan_kernel(const float* __restrict__ phase0,
                  const float* __restrict__ dt, float* __restrict__ before,
                  float* __restrict__ carry, int V, int B) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  float p = phase0[v];
  const float* d = dt + v;
  float* o = before + v;
#pragma unroll 8
  for (int t = 0; t < B; ++t) {
    o[(size_t)t * V] = p;
    p = p + d[(size_t)t * V];
    p = p - floorf(p);
  }
  carry[v] = p;
}

}  // namespace

extern "C" {

// phase0 [V], dt [B, V] -> before [B, V], carry [V].
int oscen_phase_scan(const float* phase0, const float* dt, float* before,
                     float* carry, int V, int B, void* stream) {
  if (V < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((V + kThreads - 1) / kThreads);
  phase_scan_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      phase0, dt, before, carry, V, B);
  return (int)cudaGetLastError();
}

const char* oscen_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
