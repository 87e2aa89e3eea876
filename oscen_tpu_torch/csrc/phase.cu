// Exact sequential phase accumulation for Hopper (sm_90a).
//
// Replaces the TPU kernel oscen_tpu/ops/pallas/phase.py::phase_scan: for
// every voice lane, out[t] = p; p = p + dt[t]; p = p - floor(p), the
// reference's per-sample rem_euclid(1.0) wrap in its exact op order.
//
// Layout: one thread per voice lane, the phase in a register for the whole
// block; dt and the output are time-major [B, V].  V = 256 for the poly
// synth's voices, V = 1 for the saturator's saw (4B steps per block at 4x)
// and the README synth.
//
// What bounds it on the card: the wrap is serial in time, ~3 dependent
// float ops per step, and the main paths have 8 warps (V = 256) or one
// lane (V = 1) for 132 SMs; it moves 8 bytes per step and lane.  So it is
// bound by the latency of the chain, and of every load that sits on it
// (the old body, dt loaded inside the loop, took ~70 cycles a step; with
// dt from a register ~27, its FADD -> FRND.FLOOR -> FADD chain 25.5:
// tools/scanprobe.py, PERF.md).  The design takes both off:
//  - the staged ring (scan_stage.cuh, at K7's and K8's depth of 3
//    chunks): a producer warp brings dt into shared memory with cp.async
//    (16-byte pieces for aligned 32-lane rows, V = 256; 4-byte elements
//    for any other V), and the chain warp reads each group of 8 steps from
//    registers loaded a group ahead, so no load waits on the chain.  For
//    32 lanes the chain warp stores `before` itself; for fewer (one lane
//    on the main paths) it stores into a second shared slot and the
//    producer writes each chunk back: one lane's 4-byte global stores cost
//    the chain warp more than shared-memory stores, while for full rows
//    the write-back would delay the producer's next copies (measured both
//    ways, PERF.md);
//  - the short exact wrap (short_wrap.cuh): q - c with c = (q >= 1) from
//    one FSET, q - floorf(q) on [+0, 2).  Every other q sets bit 31 or bit
//    30 of its pattern: the chain warp ORs
//    every q's bits into a per-chunk word (one LOP3 a step, no branch), and
//    a chunk whose word has either bit set is run again from its start
//    state with floorf, the reference's op (as K8's undecided chunks
//    re-run, iir.cu), and counted in a device counter that
//    oscen_phase_take_reruns reads.  On the main paths dt lies in (0, 0.5)
//    and the phase in [0, 1): no chunk re-runs.
// What the probe does not explain yet: the ring's chain warp runs ~12
// cycles a step above its chain (PERF.md).
// The true block length B bounds the loop; any B >= 1 and any V work.
//
// Numerics: built with --fmad=false and without fast-math; floorf and the
// IEEE operations round as PyTorch's elementwise ops do, so the output and
// the carry equal the plain PyTorch version bit for bit (the short wrap
// returns the same bits as q - floorf(q) wherever it is taken; the 2^32
// sweep of short_wrap.cuh checks every q).  The wrap is p - floorf(p) (rem_euclid),
// never truncf.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include "scan_stage.cuh"
#include "short_wrap.cuh"

namespace {

using oscen_stage::kChunk;
using oscen_stage::kLanes;
using oscen_stage::kStages;
using oscen_wrap::kOutside;
using oscen_wrap::short_wrap;

// (lane, chunk)s re-run with floorf since the last take (this device)
__device__ unsigned g_reruns;

// One lane's steps on the staged dt: before[t] to o[t * stride], the
// short wrap, and the OR of every q's bits.
struct PhaseBody {
  float p;
  float* o;
  int stride;
  unsigned bits;
  __device__ __forceinline__ void step(const float (&in)[1], int t) {
    o[t * stride] = p;
    const float q = p + in[0];
    bits |= __float_as_uint(q);
    p = short_wrap(q);
  }
};

// kStaged: the chain warp stores `before` into a second shared slot and
// the producer writes it back once the chunk is done
// (Producer::run_staged).
template <bool kStaged>
__global__ void __launch_bounds__(oscen_stage::kBlock)
phase_ring_kernel(const float* __restrict__ phase0,
                  const float* __restrict__ dt, float* __restrict__ before,
                  float* __restrict__ carry, int V, int B) {
  extern __shared__ __align__(16) float smem[];
  float* out_slot = smem + oscen_stage::kSlotFloats;
  const int l0 = blockIdx.x * kLanes;
  const int chunks = (B + kChunk - 1) / kChunk;
  if (threadIdx.x >= kLanes) {   // the producer warp
    const float* planes[1] = {dt};
    oscen_stage::Producer<1> prod;
    prod.init(smem, planes, 1, V, B, l0);
    if constexpr (kStaged)
      prod.run_staged(chunks, out_slot, before, 0);
    else
      prod.run(chunks, [](int) {});
    return;
  }
  const int v = l0 + threadIdx.x;
  const bool live = v < V;   // every thread syncs; live ones scan
  float p = live ? phase0[v] : 0.0f;
  for (int c = 0; c < chunks; ++c) {
    oscen_stage::chunk_ready(c);
    if (live) {
      const float* src[1];
      oscen_stage::stage_ptrs<1>(smem, c, src);
      const int n = min(kChunk, B - c * kChunk);
      PhaseBody body{
          p,
          kStaged ? out_slot + (c % kStages) * kChunk * kLanes + threadIdx.x
                  : before + (size_t)c * kChunk * V + v,
          kStaged ? kLanes : V, 0u};
      oscen_stage::run_chunk<1>(src, n, body);
      if (body.bits & kOutside) {
        // rare: the chunk again from its start state, with floorf
        float q = p;
        for (int t = 0; t < n; ++t) {
          body.o[t * body.stride] = q;
          q = q + src[0][t * kLanes];
          q = q - floorf(q);
        }
        body.p = q;
        atomicAdd(&g_reruns, 1u);
      }
      p = body.p;
    }
    if constexpr (kStaged)
      oscen_stage::bar_arrive(oscen_stage::empty_id(c));
    else
      oscen_stage::chunk_done(c, chunks);
  }
  if (live) carry[v] = p;
}

__global__ void take_reruns(unsigned* out) {
  *out = g_reruns;
  g_reruns = 0u;
}

// The reference's wrap, for the 2^32 sweep (short_wrap.cuh)
struct FloorWrap {
  __device__ float operator()(float q) const { return q - floorf(q); }
};

}  // namespace

extern "C" {

// phase0 [V], dt [B, V] -> before [B, V], carry [V].  `before` is staged
// and written back by the producer for fewer than 32 lanes, stored by the
// chain warp for full rows.
int oscen_phase_scan(const float* phase0, const float* dt, float* before,
                     float* carry, int V, int B, void* stream) {
  if (V < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((V + kLanes - 1) / kLanes);
  const cudaStream_t st = (cudaStream_t)stream;
  if (V < kLanes)
    phase_ring_kernel<true><<<grid, oscen_stage::kBlock,
                              oscen_stage::ring_bytes(2), st>>>(
        phase0, dt, before, carry, V, B);
  else
    phase_ring_kernel<false><<<grid, oscen_stage::kBlock,
                               oscen_stage::ring_bytes(1), st>>>(
        phase0, dt, before, carry, V, B);
  return (int)cudaGetLastError();
}

// *out (a device word) = the (lane, chunk)s re-run with floorf by every
// oscen_phase_scan on this device since the last take; the count restarts
// at 0.  In stream order.
int oscen_phase_take_reruns(unsigned* out, void* stream) {
  take_reruns<<<1, 1, 0, (cudaStream_t)stream>>>(out);
  return (int)cudaGetLastError();
}

// The short wrap over all 2^32 float32 patterns: counts [2] (u64)
// += (mismatches against q - floorf(q), patterns it takes).
int oscen_phase_wrap_sweep(unsigned long long* counts, void* stream) {
  return oscen_wrap::launch_wrap_sweep(counts, FloorWrap{}, stream);
}

const char* oscen_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
