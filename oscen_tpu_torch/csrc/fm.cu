// FM operator recurrences for Hopper (sm_90a).
//
// Replaces the four TPU kernels of oscen_tpu/ops/pallas/fm.py:
//   fract_phase3_kernel  <- fract_phase3 (_fract3_kernel): the three chain
//                           operators' phases, p += dt; p -= trunc(p);
//   chain3_kernel<false, .> <- fm_chain3_scan (_chain3_pipe_kernel): the
//                           fm-synth voice's operator chain op3 -> op2 -> op1
//                           with per-operator self-feedback and the route
//                           crossfade (FmOperatorChain.tick);
//   chain3_kernel<true, .>  <- pivot_chain3_scan (_pivot3_pipe_kernel): the
//                           pivot voice's chain, where the RAW sine is each
//                           operator's feedback and the enveloped signal
//                           drives the routing (PivotOperatorChain.tick);
//   fm_operator_kernel   <- fm_operator_scan (_kernel): one FM operator
//                           with feedback (FmOperator.tick).
//
// fract_phase3_kernel (K12).  Its loop stores the phase and steps it; the
// step's chain, FFMA -> FRND.TRUNC -> FADD, is its whole cost (~28 cycles
// a step, of which FRND's form prices 25.5: tools/scanprobe.py).  A step
// is q = fma(dt, inv, p) (inv = 1: p + dt, the Pallas kernel's step; the
// pivot passes base_freq*ratio and the reciprocal of the rate, as XLA
// fuses the JAX pivot tick's p + f*ratio/sr).  dt is block-constant per
// lane, so a lane whose p0 and rounded increment d = dt*inv both lie in
// [+0, 1) keeps every q in [+0, 2) for the whole block, by induction: p
// <= 1 - 2^-24 and d <= 1 - 2^-24 put the exact dt*inv below 1 (within
// half an ulp of d) and p + dt*inv below 2 - 2^-24, which rounds to at
// most 2 - 2^-23 (+0 + +0 is +0), and the wrap of such a q lies in [+0, 1)
// again.  On [+0, 2), q - truncf(q) is short_wrap.cuh's q - (q >= 1):
// FSET -> FADD.  So each lane checks p0 and d once, on their bits, before
// the loop (the sign bit clear and below 1.0f: NaN, -0.0, negatives and
// values >= 1 fail; -0.0 must, as -0 - trunc(-0) is +0 and the short
// wrap's -0 - 0 is -0), and runs the short loop, with no per-step check or
// re-run, or else the reference's loop with truncf.  A warp whose lanes
// disagree runs both.
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
// What bounds them on the card: each operator is a dependent chain of ~15
// float ops per sample (its own feedback product, the phase sum, the sine
// polynomial with its FRND, the envelope product), serial in time; 256
// voices are 8 warps for 132 SMs.  The chains move 16 bytes per sample and
// lane (28 with per-sample dt), far below the memory bound: latency, not
// bytes.  One warp per CUDA block spreads the warps over SMs.  The true
// block length B bounds every loop and the carries hold the last real
// sample; any B >= 1 and any V work.
//
// chain3_kernel (K13, K15).  Its steps are three operators' chains (op3 ->
// op2 -> op1 at each sample), and each operator's own cycle (its feedback
// product, the phase sum, the sine polynomial with its FRND, the envelope
// product) is ~15 dependent ops: ~100 cycles a step on the H100 for one
// operator alone on one warp (tools/scanprobe.py).  One warp running all
// three in tick order took ~255 cycles a step with its inputs loaded inside
// the loop, ~135 on the staged ring; skewed by a sample within the warp
// (the TPU kernel's schedule: op3 on sample i, op2 on i - 1, op1 on i - 2)
// ~160, as in-order issue from one warp does not overlap three such
// chains.  The design:
//  - each operator on its own warp (its own scheduler), the operators
//    skewed by a chunk of 32 samples: at step s op3's warp runs chunk s,
//    op2's chunk s - 1 and op1's chunk s - 2, and all four warps of the
//    block (the producer's too) meet at one named barrier per step, so a
//    step takes one operator's chain over a chunk.  What crosses operators
//    goes through shared memory, a chunk at a time, double-buffered by
//    chunk: op3's route to op2 (the fm chain's a = a3 * (1 - route) and
//    b = a3 * route; the pivot's a3, from which op2 forms both inside its
//    fused multiply-adds), and op2's modulation of op1, pm1 = a2 + b.
//    The first two steps fill the pipeline and the last two drain it.
//    Each operator keeps its own wrap, carry and the JAX association; only
//    the schedule moves.
//  - each operator's per-sample planes (its envelope and, with per-sample
//    dt, its dt) through its own staged ring (scan_stage.cuh's Producer,
//    one per operator, in the producer warp): at step s the producer copies
//    op3's chunk s + 2, op2's s + 1 and op1's s, each two steps ahead of its
//    use, so each ring is shaped for its operator's skew and no stage has to
//    stay live for a later operator.  The operator warps read a group of 8
//    steps ahead (run_chunk).  dt rows, fb and mix stay in registers.  The
//    rings and the route take 60 KB of shared memory, 96 KB with per-sample
//    dt (the launch opts in).
//  - op1's warp stores y (V = 256: full rows).
//
// Numerics: built with --fmad=false and without fast-math, so every product
// and sum rounds as PyTorch's separate elementwise ops do, except the
// explicit __fmaf_rn, which fmath.fma reproduces; every output equals the
// plain PyTorch version bit for bit.  The pivot chain fuses what XLA fuses
// in the JAX pivot tick: each operator's fma(prev, fb, ph + pm), op2's
// fma(a3, 1 - route, ph), op1's modulation fma(a3, route, a2) and the
// sine's Horner steps (sin_turns<true>); the fm chain and the lone operator
// round each op.  Every chain phase steps by fma(dt, inv, ph).  The sine
// rounds half to even (rintf, as torch.round; roundf would round half away
// from zero).  The FM wrap is p - truncf(p), Rust's .fract(), not the
// oscillators' floorf.  Each operator keeps the JAX package's association:
//   chains:   y = sin_turns((ph + pm) + prev * fb) * (env * lvl)
//   operator: y = sin_turns(ph + (pm + prev * fb)) * env * lvl
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include "scan_stage.cuh"
#include "short_wrap.cuh"

namespace {

using oscen_stage::kChunk;
using oscen_stage::kLanes;
constexpr int kThreads = 32;

// float32 roundings of oscen_tpu/ops/fastmath.py SIN_TURNS_COEFFS
constexpr float kC0 = 0x1.921dfep+2f;
constexpr float kC1 = -0x1.4aa97ap+5f;
constexpr float kC2 = 0x1.45912ep+6f;
constexpr float kC3 = -0x1.2a8046p+6f;
constexpr float kC4 = 0x1.08897cp+5f;

// c + a * b: one rounding (kFused, __fmaf_rn) or two
template <bool kFused>
__device__ __forceinline__ float madd(float a, float b, float c) {
  if constexpr (kFused)
    return __fmaf_rn(a, b, c);
  else
    return c + a * b;
}

// sin(2*pi*x) for x in turns: the JAX package's degree-9 odd polynomial,
// each Horner step one fused multiply-add when kFused (sin_turns_fma)
template <bool kFused = false>
__device__ __forceinline__ float sin_turns(float x) {
  const float w = x - rintf(x);
  const float u = w * w;
  float acc = madd<kFused>(u, kC4, kC3);
  acc = madd<kFused>(acc, u, kC2);
  acc = madd<kFused>(acc, u, kC1);
  acc = madd<kFused>(acc, u, kC0);
  return acc * w;
}

__device__ __forceinline__ float fract_step(float p, float dt) {
  p = p + dt;
  return p - truncf(p);  // Rust .fract()
}

// a chain phase's step: fma(dt, inv, p) (inv = 1: p + dt), .fract()
__device__ __forceinline__ float fract_fma(float p, float dt, float inv) {
  p = __fmaf_rn(dt, inv, p);
  return p - truncf(p);
}

// Whether x lies in [+0, 1), on its bits: the sign clear and below 1.0f.
__device__ __forceinline__ bool in_unit(float x) {
  return __float_as_uint(x) < 0x3F800000u;
}

__global__ void __launch_bounds__(kThreads)
fract_phase3_kernel(const float* __restrict__ phases,
                    const float* __restrict__ dt, float* __restrict__ out,
                    float* __restrict__ carry, int V, int B, float inv) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 3 * V) return;
  const int r = i / V;
  const int v = i - r * V;
  float p = phases[i];
  const float d = dt[i];
  float* o = out + (size_t)r * B * V + v;
  if (in_unit(p) && in_unit(d * inv)) {   // every q in [+0, 2): short wrap
#pragma unroll 8
    for (int t = 0; t < B; ++t) {
      o[(size_t)t * V] = p;
      p = oscen_wrap::short_wrap(__fmaf_rn(d, inv, p));
    }
  } else {
#pragma unroll 8
    for (int t = 0; t < B; ++t) {
      o[(size_t)t * V] = p;
      p = fract_fma(p, d, inv);
    }
  }
  carry[i] = p;
}

// The reference's wrap, for the 2^32 sweep (short_wrap.cuh)
struct TruncWrap {
  __device__ float operator()(float q) const { return q - truncf(q); }
};

// chain3_kernel's block: warps 0, 1, 2 run op3, op2, op1 (each operator
// on its own scheduler), warp 3 is the producer; they step in lockstep, one
// 32-sample chunk a step, through named barrier 1.
constexpr int kOpWarps = 3;
constexpr int kChainBlock = (kOpWarps + 1) * kLanes;
// the route between operators: op3's a and b (the pivot's a3 in a's
// place), op2's pm1, each [2][kChunk][kLanes] (chunk k in buffer k % 2)
constexpr int kRouteFloats = 2 * kChunk * kLanes;

__device__ __forceinline__ void step_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kChainBlock) : "memory");
}

// Operator kOp (0: op3, 1: op2, 2: op1, 3: the lone operator of
// fm_operator_kernel) of one voice lane over one chunk; staged inputs: its
// envelope, (kDtP) its dt, then what it takes from the operator before it
// (op2: the fm chain's a and b, the pivot's a3; op1: pm1) or, for the lone
// operator, its pm, fb and lvl.  The pivot's (kPivot) products into sums
// are fused multiply-adds.
template <int kOp, bool kPivot, bool kDtP>
struct OpBody {
  static constexpr int kRouted = kOp == 1 ? (kPivot ? 1 : 2)
                                 : kOp == 2 ? 1 : kOp == 3 ? 3 : 0;
  static constexpr int kP = 1 + kDtP + kRouted;
  // the operator that forms the route: op3 in the fm chain, op2 (inside
  // its fused multiply-adds) in the pivot
  static constexpr bool kRoutes = kPivot ? kOp == 1 : kOp == 0;
  float ph, p, fb;   // phase, feedback carry, feedback
  float d;           // dt row (block-constant dt)
  float inv;         // a chain phase steps by fma(dt, inv, ph)
  float m, om;       // the route and 1 - route (kRoutes)
  float* out;        // op3: a (b kRouteFloats further; the pivot: a3);
                     // op2: pm1; op1 and the lone operator: y
  int stride;        // kLanes, or V for y

  __device__ __forceinline__ void step(const float (&in)[kP], int t) {
    const float dt = kDtP ? in[1] : d;
    constexpr int r = 1 + kDtP;   // the first routed input
    if constexpr (kOp == 0) {      // op3: no phase modulation
      const float s3 = sin_turns<kPivot>(madd<kPivot>(p, fb, ph));
      const float a3 = s3 * in[0];
      if constexpr (kPivot) {
        out[t * kLanes] = a3;
      } else {
        out[t * kLanes] = a3 * om;
        out[kRouteFloats + t * kLanes] = a3 * m;
      }
      p = kPivot ? s3 : a3;
    } else if constexpr (kOp == 1 && kPivot) {   // op2 of the pivot
      const float a3 = in[r];
      const float s2 =
          sin_turns<true>(__fmaf_rn(p, fb, __fmaf_rn(a3, om, ph)));
      const float a2 = s2 * in[0];
      out[t * kLanes] = __fmaf_rn(a3, m, a2);   // op1's: a2 + a3 * route
      p = s2;
    } else if constexpr (kOp == 1) {   // op2, modulated by the route's a
      const float s2 = sin_turns((ph + in[r]) + p * fb);
      const float a2 = s2 * in[0];
      out[t * kLanes] = a2 + in[r + 1];   // op1's modulation: + the route's b
      p = a2;
    } else if constexpr (kOp == 2) {   // op1, the carrier
      const float s1 = sin_turns<kPivot>(madd<kPivot>(p, fb, ph + in[r]));
      const float y1 = s1 * in[0];
      out[t * stride] = y1;
      p = kPivot ? s1 : y1;
    } else {   // the lone operator: FmOperator.tick's association
      const float y1 = sin_turns(ph + (in[r] + p * in[r + 1])) * in[0] *
                       in[r + 2];
      out[t * stride] = y1;
      p = y1;
    }
    if constexpr (kOp == 3)
      ph = fract_step(ph, dt);
    else
      ph = fract_fma(ph, dt, inv);
  }
};

// One operator warp's run: at step s it runs chunk s - kOp (if there is
// one), then waits for the step's barrier.
template <int kOp, bool kPivot, bool kDtP>
__device__ __forceinline__ void run_operator(
    const float* smem, float* route, const float* __restrict__ phases,
    const float* __restrict__ prevs, const float* __restrict__ dt,
    const float* __restrict__ fb, const float* __restrict__ mix,
    float* __restrict__ y, float* __restrict__ ph_out,
    float* __restrict__ pv_out, int V, int B, int chunks, float inv) {
  using Body = OpBody<kOp, kPivot, kDtP>;
  constexpr int kP = Body::kP;
  constexpr int kOpPlanes = 1 + kDtP;
  const int lane = threadIdx.x % kLanes;
  const int v = blockIdx.x * kLanes + lane;
  const bool live = v < V;   // every thread syncs; live ones scan
  Body body{};
  if (live) {
    body.ph = phases[kOp * V + v];
    body.p = prevs[kOp * V + v];
    body.fb = fb[kOp * V + v];
    body.inv = inv;
    if constexpr (!kDtP) body.d = dt[kOp * V + v];
    if constexpr (Body::kRoutes) {
      body.m = mix[v];
      body.om = 1.0f - body.m;
    }
  }
  const float* planes = smem + kOp * kOpPlanes * oscen_stage::kSlotFloats;
  float* const a_buf = route;
  float* const pm_buf = route + 2 * kRouteFloats;
  step_sync();   // chunk 0's inputs have landed
  for (int s = 0; s < chunks + kOpWarps - 1; ++s) {
    const int k = s - kOp;
    if (live && k >= 0 && k < chunks) {
      const int stage = (k % oscen_stage::kStages) * kChunk * kLanes + lane;
      const int buf = (k % 2) * kChunk * kLanes + lane;
      const float* src[kP];
#pragma unroll
      for (int q = 0; q < kOpPlanes; ++q)
        src[q] = planes + q * oscen_stage::kSlotFloats + stage;
      if constexpr (kOp == 0) {
        body.out = a_buf + buf;
      } else if constexpr (kOp == 1) {
        src[kOpPlanes] = a_buf + buf;
        if constexpr (!kPivot)
          src[kOpPlanes + 1] = a_buf + kRouteFloats + buf;
        body.out = pm_buf + buf;
      } else {
        src[kOpPlanes] = pm_buf + buf;
        body.out = y + (size_t)k * kChunk * V + v;
        body.stride = V;
      }
      oscen_stage::run_chunk<kP>(src, min(kChunk, B - k * kChunk), body);
    }
    step_sync();
  }
  if (live) {
    ph_out[kOp * V + v] = body.ph;
    pv_out[kOp * V + v] = body.p;
  }
}

// The producer's copies for step s: op3's inputs of chunk s + 2, op2's of
// s + 1, op1's of s (each operator's ring holds its own chunks, two steps
// ahead of their use), one commit group per operator, empty where there is
// no such chunk.
template <int kN>
__device__ __forceinline__ void issue_step(oscen_stage::Producer<kN> (&prod)[3],
                                           int s, int chunks) {
#pragma unroll
  for (int r = 0; r < kOpWarps; ++r) {
    const int k = s + kOpWarps - 1 - r;
    if (k >= 0 && k < chunks)
      prod[r].issue(k);
    else
      oscen_stage::commit();
  }
}

template <bool kPivot, bool kDtP>
__global__ void __launch_bounds__(kChainBlock)
chain3_kernel(const float* __restrict__ phases,
              const float* __restrict__ prevs, const float* __restrict__ dt,
              const float* __restrict__ fb, const float* __restrict__ mix,
              const float* __restrict__ e3, const float* __restrict__ e2,
              const float* __restrict__ e1, float* __restrict__ y,
              float* __restrict__ ph_out, float* __restrict__ pv_out, int V,
              int B, float inv) {
  constexpr int kOpPlanes = 1 + kDtP;
  // dynamic shared memory: each operator's planes' slots, then the route
  extern __shared__ __align__(16) float smem[];
  float* route = smem + kOpWarps * kOpPlanes * oscen_stage::kSlotFloats;
  const int chunks = (B + kChunk - 1) / kChunk;
  const int warp = threadIdx.x / kLanes;
  if (warp == kOpWarps) {   // the producer warp
    const size_t plane = (size_t)B * V;
    const float* src[3][2] = {
        {e3, dt}, {e2, dt + plane}, {e1, dt + 2 * plane}};
    oscen_stage::Producer<kOpPlanes> prod[3];
#pragma unroll
    for (int r = 0; r < kOpWarps; ++r)
      prod[r].init(smem + r * kOpPlanes * oscen_stage::kSlotFloats, src[r],
                   kOpPlanes, V, B, blockIdx.x * kLanes);
    issue_step(prod, -2, chunks);
    issue_step(prod, -1, chunks);
    oscen_stage::wait_groups<kOpWarps>();   // step 0's inputs
    __syncwarp();
    step_sync();
    for (int s = 0; s < chunks + kOpWarps - 1; ++s) {
      issue_step(prod, s, chunks);
      oscen_stage::wait_groups<kOpWarps>();   // step s + 1's inputs
      __syncwarp();
      step_sync();
    }
    return;
  }
#define OSCEN_OPERATOR(n)                                                   \
  run_operator<n, kPivot, kDtP>(smem, route, phases, prevs, dt, fb, mix, y, \
                                ph_out, pv_out, V, B, chunks, inv)
  if (warp == 0)
    OSCEN_OPERATOR(0);
  else if (warp == 1)
    OSCEN_OPERATOR(1);
  else
    OSCEN_OPERATOR(2);
#undef OSCEN_OPERATOR
}

// fm_operator_kernel (K14): one operator with self-feedback over five
// per-sample planes (dt, pm, fb, env, lvl), serial in time per lane.  Its
// loop-carried cycle is the operator's own chain, 17 ops (* fb, + pm,
// + phase, the sine's 12 with its FRND, * env, * lvl: the reference's
// (sin * env) * lvl, so lvl is not folded into env as the chains fold it);
// the phase's wrap runs beside it.  The design is one chain3_kernel
// operator's (OpBody<3, ...>): the five planes through one staged ring (a
// producer warp's cp.async, scan_stage.cuh), read a group of 8 steps ahead,
// and y staged in a shared slot that the producer writes back
// (Producer::run_staged), so the chain warp's stream holds only the chain,
// shared loads and stores.  Dynamic shared memory: 5 slots, then the y
// slot (72 KB; the launch opts in).
__global__ void __launch_bounds__(oscen_stage::kBlock)
fm_operator_kernel(const float* __restrict__ phase0,
                   const float* __restrict__ prev0,
                   const float* __restrict__ dt, const float* __restrict__ pm,
                   const float* __restrict__ fb,
                   const float* __restrict__ env,
                   const float* __restrict__ lvl, float* __restrict__ y,
                   float* __restrict__ phase_out,
                   float* __restrict__ prev_out, int V, int B) {
  using Body = OpBody<3, false, true>;
  constexpr int kP = Body::kP;
  extern __shared__ __align__(16) float smem[];
  float* const y_slot = smem + kP * oscen_stage::kSlotFloats;
  const int l0 = blockIdx.x * kLanes;
  const int chunks = (B + kChunk - 1) / kChunk;
  if (threadIdx.x >= kLanes) {   // the producer warp
    const float* planes[kP] = {env, dt, pm, fb, lvl};
    oscen_stage::Producer<kP> prod;
    prod.init(smem, planes, kP, V, B, l0);
    prod.run_staged(chunks, y_slot, y, 0);
    return;
  }
  const int v = l0 + threadIdx.x;
  const bool live = v < V;   // every thread syncs; live ones scan
  Body body{};
  body.stride = kLanes;
  if (live) {
    body.ph = phase0[v];
    body.p = prev0[v];
  }
  for (int c = 0; c < chunks; ++c) {
    oscen_stage::chunk_ready(c);
    if (live) {
      const float* src[kP];
      oscen_stage::stage_ptrs<kP>(smem, c, src);
      body.out = y_slot + (c % oscen_stage::kStages) * kChunk * kLanes +
                 threadIdx.x;
      oscen_stage::run_chunk<kP>(src, min(kChunk, B - c * kChunk), body);
    }
    // every chunk's stage is handed back: the producer writes y back
    oscen_stage::bar_arrive(oscen_stage::empty_id(c));
  }
  if (live) {
    phase_out[v] = body.ph;
    prev_out[v] = body.p;
  }
}

template <bool kPivot, bool kDtP>
cudaError_t launch_chain3(const float* phases, const float* prevs,
                          const float* dt, const float* fb, const float* mix,
                          const float* e3, const float* e2, const float* e1,
                          float* y, float* ph_out, float* pv_out, int V, int B,
                          float inv, cudaStream_t stream) {
  // each operator's planes' slots and the route (3 x 2 chunks: 2 slots):
  // 60 KB, 96 KB with per-sample dt, above the 48 KB default
  const int slots = kOpWarps * (1 + kDtP) + 2;
  const cudaError_t err =
      oscen_stage::allow_ring<chain3_kernel<kPivot, kDtP>>(slots);
  if (err != cudaSuccess) return err;
  const dim3 grid((V + kLanes - 1) / kLanes);
  chain3_kernel<kPivot, kDtP>
      <<<grid, kChainBlock, oscen_stage::ring_bytes(slots), stream>>>(
          phases, prevs, dt, fb, mix, e3, e2, e1, y, ph_out, pv_out, V, B,
          inv);
  return cudaGetLastError();
}

template <bool kPivot>
int launch_chain3(const float* phases, const float* prevs, const float* dt,
                  const float* fb, const float* mix, const float* e3,
                  const float* e2, const float* e1, float* y, float* ph_out,
                  float* pv_out, int V, int B, int dt_stride, float inv,
                  void* stream) {
  if (V < 1 || B < 1 || (dt_stride != 0 && dt_stride != V))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(dt_stride
                   ? launch_chain3<kPivot, true>(phases, prevs, dt, fb, mix,
                                                 e3, e2, e1, y, ph_out,
                                                 pv_out, V, B, inv, st)
                   : launch_chain3<kPivot, false>(phases, prevs, dt, fb, mix,
                                                  e3, e2, e1, y, ph_out,
                                                  pv_out, V, B, inv, st));
}

}  // namespace

extern "C" {

// phases, dt [3, V] -> out [3, B, V] (pre-increment phases), carry [3, V];
// each step fma(dt, inv, p).
int oscen_fract_phase3(const float* phases, const float* dt, float* out,
                       float* carry, int V, int B, float inv, void* stream) {
  if (V < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((3 * V + kThreads - 1) / kThreads);
  fract_phase3_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      phases, dt, out, carry, V, B, inv);
  return (int)cudaGetLastError();
}

// K12's short wrap over all 2^32 float32 patterns: counts [2] (u64)
// += (mismatches against q - truncf(q), patterns it takes).
int oscen_fract_wrap_sweep(unsigned long long* counts, void* stream) {
  return oscen_wrap::launch_wrap_sweep(counts, TruncWrap{}, stream);
}

// phases, prevs, fb [3, V]; dt [3, B, V] (dt_stride V) or [3, 1, V]
// (dt_stride 0); mix [V]; e3, e2, e1 [B, V] (level-folded envelopes); each
// phase step fma(dt, inv, p) -> y [B, V], phases' and prevs' [3, V].
int oscen_fm_chain3_scan(const float* phases, const float* prevs,
                         const float* dt, const float* fb, const float* mix,
                         const float* e3, const float* e2, const float* e1,
                         float* y, float* ph_out, float* pv_out, int V, int B,
                         int dt_stride, float inv, void* stream) {
  return launch_chain3<false>(phases, prevs, dt, fb, mix, e3, e2, e1, y,
                              ph_out, pv_out, V, B, dt_stride, inv, stream);
}

// as oscen_fm_chain3_scan; prevs carry the raw sines, and the products
// into sums are fused multiply-adds.
int oscen_pivot_chain3_scan(const float* phases, const float* prevs,
                            const float* dt, const float* fb,
                            const float* mix, const float* e3,
                            const float* e2, const float* e1, float* y,
                            float* ph_out, float* pv_out, int V, int B,
                            int dt_stride, float inv, void* stream) {
  return launch_chain3<true>(phases, prevs, dt, fb, mix, e3, e2, e1, y,
                             ph_out, pv_out, V, B, dt_stride, inv, stream);
}

// phase0, prev0 [V]; dt, pm, fb, env, lvl [B, V] -> y [B, V], phase',
// prev' [V].
int oscen_fm_operator_scan(const float* phase0, const float* prev0,
                           const float* dt, const float* pm, const float* fb,
                           const float* env, const float* lvl, float* y,
                           float* phase_out, float* prev_out, int V, int B,
                           void* stream) {
  if (V < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const int slots = OpBody<3, false, true>::kP + 1;
  const cudaError_t err =
      oscen_stage::allow_ring<fm_operator_kernel>(slots);
  if (err != cudaSuccess) return (int)err;
  fm_operator_kernel<<<(V + kLanes - 1) / kLanes, oscen_stage::kBlock,
                       oscen_stage::ring_bytes(slots),
                       (cudaStream_t)stream>>>(
      phase0, prev0, dt, pm, fb, env, lvl, y, phase_out, prev_out, V, B);
  return (int)cudaGetLastError();
}

const char* oscen_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
