// Probes of the scans' per-step time (tools/scanprobe.py): the bodies of
// K6 (csrc/phase.cu), K7 and K8 (csrc/iir.cu) before their redesign, each
// with one cost taken out, and a latency probe of the dependent ops their
// chains are made of.  On no model's path.
//
// phase_probe<XC>: K6's old body (one thread per lane, dt loaded and
// before stored inside the loop, #pragma unroll 8); XC reads dt once into
// a register instead of per step.
// phase_ring_floor: K6's new ring (csrc/phase.cu, `before` stored by the
// chain warp) with the reference's floorf wrap instead of the short one.
// tpt_probe<XC, U>: K7's old body (loads inside the loop, #pragma unroll
// U); XC reads x once into a register instead of per step.
// lp18_probe<XC, TANH, DIV, U>: K8's old body; TANH 0 replaces the float64
// tanh by the identity, DIV 0 the IEEE division by a product with the
// hoisted reciprocal of the first row (rows only).
// lat_kernel: clock64() around 4096 dependent steps of each op kind.
// probe_chain: K13 / K15 as one warp per 32 lanes running all three
// operators (fm.cu gives each operator its own warp): (1) skewed by a
// sample (op3 on sample i, op2 on i - 1, op1 on i - 2) with the inputs
// loaded from global memory inside the loop, (2) in tick order on the
// staged ring, (6) skewed by a sample on the ring, and what one
// operator's chain costs: (3) op3 alone on the ring, (4) (6) with the sine
// unrounded, (5) (6) without the phase wraps; with copies of fm.cu's sine
// and wrap (fm.cu keeps the only shipped copy).
// probe_biquad: K9 (csrc/iir.cu) before its redesign, (0) as is (one
// thread per lane, x and the coefficients loaded inside the loop, #pragma
// unroll 4), (1) with x and the coefficients read once into registers,
// (2) without the snaps, (3) both: the bare chain; and on the staged ring
// with every coefficient a plane, (4) without snaps, (5) y stored by the
// chain warp, (6) iir.cu's body (y staged), (7) the chain warp reading no
// shared memory, (8) the producer copying nothing.
// probe_operator: K14 (csrc/fm.cu) before its redesign, (0) as is, (1)
// with the five planes read once into registers, (2) without the * lvl,
// (3) both; and on the staged ring, (4) y stored by the chain warp, (5)
// fm.cu's body (y staged), (6) the chain warp reading no shared memory,
// (7) the producer copying nothing.
//
// probe_fract_direct: K17's direct layout (csrc/fractabl.cu: K12's body,
// the short wrap on a lane whose p0 and dt lie in [+0, 1)) storing its
// [B, 3, V] output (0, the tool's layout) or K12's [3, B, V] (1): what the
// layout alone costs against K12.
//
// Built like the other sources (--fmad=false); variants by number, as
// tools/scanprobe.py names them.
#include <cuda_runtime.h>

#include "scan_stage.cuh"
#include "short_wrap.cuh"

namespace {

template <int XC>
__global__ void __launch_bounds__(32)
phase_probe(const float* __restrict__ phase0, const float* __restrict__ dt,
            float* __restrict__ before, float* __restrict__ carry, int V,
            int B) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  float p = phase0[v];
  const float* d = dt + v;
  const float d0 = d[0];
  float* o = before + v;
#pragma unroll 8
  for (int t = 0; t < B; ++t) {
    o[(size_t)t * V] = p;
    p = p + (XC ? d0 : d[(size_t)t * V]);
    p = p - floorf(p);
  }
  carry[v] = p;
}

struct FloorBody {
  float p;
  float* o;
  int stride;
  __device__ __forceinline__ void step(const float (&in)[1], int t) {
    o[t * stride] = p;
    p = p + in[0];
    p = p - floorf(p);
  }
};

__global__ void __launch_bounds__(oscen_stage::kBlock)
phase_ring_floor(const float* __restrict__ phase0,
                 const float* __restrict__ dt, float* __restrict__ before,
                 float* __restrict__ carry, int V, int B) {
  extern __shared__ __align__(16) float smem[];
  const int l0 = blockIdx.x * oscen_stage::kLanes;
  const int chunks = (B + oscen_stage::kChunk - 1) / oscen_stage::kChunk;
  if (threadIdx.x >= oscen_stage::kLanes) {
    const float* planes[1] = {dt};
    oscen_stage::Producer<1> prod;
    prod.init(smem, planes, 1, V, B, l0);
    prod.run(chunks, [](int) {});
    return;
  }
  const int v = l0 + threadIdx.x;
  const bool live = v < V;
  float p = live ? phase0[v] : 0.0f;
  for (int c = 0; c < chunks; ++c) {
    oscen_stage::chunk_ready(c);
    if (live) {
      const float* src[1];
      oscen_stage::stage_ptrs<1>(smem, c, src);
      FloorBody body{p, before + (size_t)c * oscen_stage::kChunk * V + v, V};
      oscen_stage::run_chunk<1>(
          src, min(oscen_stage::kChunk, B - c * oscen_stage::kChunk), body);
      p = body.p;
    }
    oscen_stage::chunk_done(c, chunks);
  }
  if (live) carry[v] = p;
}

template <int XC, int U>
__global__ void __launch_bounds__(32)
tpt_probe(const float* __restrict__ x, const float* __restrict__ h,
          const float* __restrict__ g, const float* __restrict__ k,
          const float* __restrict__ z0_in, const float* __restrict__ z1_in,
          float* __restrict__ y, float* __restrict__ z0_out,
          float* __restrict__ z1_out, int V, int B, int hs, int gs, int ks) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  float z0 = z0_in[v];
  float z1 = z1_in[v];
  const float x0 = x[v];
#pragma unroll U
  for (int t = 0; t < B; ++t) {
    const size_t i = (size_t)t * V + v;
    const float xt = XC ? x0 : x[i];
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

template <int XC, int TANH, int DIV, int U>
__global__ void __launch_bounds__(32)
lp18_probe(const float* __restrict__ x, const float* __restrict__ g,
           const float* __restrict__ h, const float* __restrict__ z_in,
           float* __restrict__ y, float* __restrict__ z_out, int V, int B,
           int gs, int hs) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  float z0 = z_in[v];
  float z1 = z_in[V + v];
  float z2 = z_in[2 * V + v];
  const float x0 = x[v];
  const float r0 = 1.0f / (1.0f + g[v]);
#pragma unroll U
  for (int t = 0; t < B; ++t) {
    const size_t i = (size_t)t * V + v;
    const float xt = XC ? x0 : x[i];
    const float gt = g[(size_t)t * gs + v];
    const float ht = h[(size_t)t * hs + v];
    const float a = xt - ht * z0 - z1 - z2;
    const float hp = DIV ? a / (1.0f + gt) : a * r0;
    const float bp1 = gt * hp + z0;
    z0 = TANH ? (float)tanh((double)bp1) : bp1;
    const float bp2 = gt * bp1 + z1;
    z1 = bp2;
    z2 = gt * bp2 + z2;
    y[i] = z2;
  }
  z_out[v] = z0;
  z_out[V + v] = z1;
  z_out[2 * V + v] = z2;
}

}  // namespace

// ---- K13 / K15 probes ------------------------------------------------
namespace probe_fm {

using oscen_stage::kChunk;
using oscen_stage::kLanes;

constexpr float kC0 = 0x1.921dfep+2f;
constexpr float kC1 = -0x1.4aa97ap+5f;
constexpr float kC2 = 0x1.45912ep+6f;
constexpr float kC3 = -0x1.2a8046p+6f;
constexpr float kC4 = 0x1.08897cp+5f;

// kRound false: the sine without its rounding (w = x; probe only)
template <bool kRound = true>
__device__ __forceinline__ float sin_turns(float x) {
  const float w = kRound ? x - rintf(x) : x;
  const float u = w * w;
  float acc = u * kC4;
  acc = acc + kC3;
  acc = acc * u + kC2;
  acc = acc * u + kC1;
  acc = acc * u + kC0;
  return acc * w;
}

// kWrap false: no wrap (probe only)
template <bool kWrap = true>
__device__ __forceinline__ float fract_step(float p, float dt) {
  p = p + dt;
  return kWrap ? p - truncf(p) : p;
}

// the state both bodies carry
template <bool kPivot, bool kDtP>
struct ChainState {
  static constexpr int kP = kDtP ? 6 : 3;
  float ph3, ph2, ph1, p3, p2, p1, fb3, fb2, fb1, m, om, d3, d2, d1;
  float e2_1, e1_1, e1_2, d2_1, d1_1, d1_2, a, b, pm1;
  float* y;
  int row0;
  int V;
};

// the old tick order: op3 -> op2 -> op1 within the sample
template <bool kPivot, bool kDtP>
struct TickBody : ChainState<kPivot, kDtP> {
  using ChainState<kPivot, kDtP>::kP;
  __device__ __forceinline__ void step(const float (&in)[kP], int t) {
    auto& q = *this;
    const float s3 = sin_turns(q.ph3 + q.p3 * q.fb3);
    const float a3 = s3 * in[0];
    const float a = a3 * q.om, b = a3 * q.m;
    q.p3 = kPivot ? s3 : a3;
    q.ph3 = fract_step(q.ph3, kDtP ? in[kP - 3] : q.d3);
    const float s2 = sin_turns((q.ph2 + a) + q.p2 * q.fb2);
    const float a2 = s2 * in[1];
    const float pm1 = a2 + b;
    q.p2 = kPivot ? s2 : a2;
    q.ph2 = fract_step(q.ph2, kDtP ? in[kP - 2] : q.d2);
    const float s1 = sin_turns((q.ph1 + pm1) + q.p1 * q.fb1);
    const float y1 = s1 * in[2];
    q.p1 = kPivot ? s1 : y1;
    q.ph1 = fract_step(q.ph1, kDtP ? in[kP - 1] : q.d1);
    q.y[(ptrdiff_t)(q.row0 + t) * q.V] = y1;
  }
};

// the operators skewed by a sample in one warp (op3 on sample i, op2 on
// i - 1, op1 on i - 2, the route carried in registers); kMode 0 exact, 1
// op3 alone (one operator's chain), 2 the sine without its rounding, 3 no
// phase wraps
template <bool kPivot, bool kDtP, int kMode = 0>
struct SkewBody : ChainState<kPivot, kDtP> {
  using ChainState<kPivot, kDtP>::kP;
  static constexpr bool kR = kMode != 2, kW = kMode != 3;
  __device__ __forceinline__ float op1(float e1, float dt1) {
    if constexpr (kMode == 1) return this->a;
    const float s1 =
        sin_turns<kR>((this->ph1 + this->pm1) + this->p1 * this->fb1);
    const float y1 = s1 * e1;
    this->p1 = kPivot ? s1 : y1;
    this->ph1 = fract_step<kW>(this->ph1, dt1);
    return y1;
  }
  __device__ __forceinline__ void op2(float e2, float dt2) {
    if constexpr (kMode == 1) return;
    const float s2 =
        sin_turns<kR>((this->ph2 + this->a) + this->p2 * this->fb2);
    const float a2 = s2 * e2;
    this->pm1 = a2 + this->b;
    this->p2 = kPivot ? s2 : a2;
    this->ph2 = fract_step<kW>(this->ph2, dt2);
  }
  __device__ __forceinline__ void op3(float e3, float dt3) {
    const float s3 = sin_turns<kR>(this->ph3 + this->p3 * this->fb3);
    const float a3 = s3 * e3;
    this->a = a3 * this->om;
    this->b = a3 * this->m;
    this->p3 = kPivot ? s3 : a3;
    this->ph3 = fract_step<kW>(this->ph3, dt3);
  }
  __device__ __forceinline__ void shift(const float (&in)[kP]) {
    this->e1_2 = this->e1_1;
    this->e1_1 = in[2];
    this->e2_1 = in[1];
    if constexpr (kDtP) {
      this->d1_2 = this->d1_1;
      this->d1_1 = in[5];
      this->d2_1 = in[4];
    }
  }
  __device__ __forceinline__ float dt1() const {
    return kDtP ? this->d1_2 : this->d1;
  }
  __device__ __forceinline__ float dt2() const {
    return kDtP ? this->d2_1 : this->d2;
  }
  __device__ __forceinline__ void step(const float (&in)[kP], int t) {
    this->y[(ptrdiff_t)(this->row0 + t) * this->V] = op1(this->e1_2, dt1());
    op2(this->e2_1, dt2());
    op3(in[0], kDtP ? in[kP - 3] : this->d3);
    shift(in);
  }
  __device__ __forceinline__ void fill(const float (&in)[kP], int k) {
    if (k >= 1) op2(this->e2_1, dt2());
    op3(in[0], kDtP ? in[kP - 3] : this->d3);
    shift(in);
  }
  __device__ __forceinline__ void drain(int j, int B) {
    if (B + j >= 2)
      this->y[(ptrdiff_t)(B + j - 2) * this->V] = op1(this->e1_2, dt1());
    if (j == 0) op2(this->e2_1, dt2());
    this->e1_2 = this->e1_1;
    if constexpr (kDtP) this->d1_2 = this->d1_1;
  }
};

template <bool kDtP, class Body>
__device__ __forceinline__ void init(Body& q, const float* phases,
                                     const float* prevs, const float* dt,
                                     const float* fb, const float* mix,
                                     float* y, int V, int v) {
  q.y = y + v;
  q.V = V;
  q.ph3 = phases[v];
  q.ph2 = phases[V + v];
  q.ph1 = phases[2 * V + v];
  q.p3 = prevs[v];
  q.p2 = prevs[V + v];
  q.p1 = prevs[2 * V + v];
  q.fb3 = fb[v];
  q.fb2 = fb[V + v];
  q.fb1 = fb[2 * V + v];
  q.m = mix[v];
  q.om = 1.0f - q.m;
  if constexpr (!kDtP) {
    q.d3 = dt[v];
    q.d2 = dt[V + v];
    q.d1 = dt[2 * V + v];
  }
}

template <class Body>
__device__ __forceinline__ void finish(const Body& q, float* ph_out,
                                       float* pv_out, int V, int v) {
  ph_out[v] = q.ph3;
  ph_out[V + v] = q.ph2;
  ph_out[2 * V + v] = q.ph1;
  pv_out[v] = q.p3;
  pv_out[V + v] = q.p2;
  pv_out[2 * V + v] = q.p1;
}

#define OSCEN_CHAIN_ARGS                                                     \
  const float *__restrict__ phases, const float *__restrict__ prevs,        \
      const float *__restrict__ dt, const float *__restrict__ fb,           \
      const float *__restrict__ mix, const float *__restrict__ e3,          \
      const float *__restrict__ e2, const float *__restrict__ e1,           \
      float *__restrict__ y, float *__restrict__ ph_out,                    \
      float *__restrict__ pv_out, int V, int B

// (1) the skewed body, its inputs loaded from global memory in the loop
template <bool kPivot, bool kDtP>
__global__ void __launch_bounds__(32) chain_global(OSCEN_CHAIN_ARGS) {
  using Body = SkewBody<kPivot, kDtP>;
  constexpr int kP = Body::kP;
  const int v = blockIdx.x * 32 + threadIdx.x;
  if (v >= V) return;
  Body q{};
  init<kDtP>(q, phases, prevs, dt, fb, mix, y, V, v);
  q.row0 = -2;
  const size_t plane = (size_t)B * V;
  const float* src[6] = {e3 + v, e2 + v, e1 + v, dt + v, dt + plane + v,
                         dt + 2 * plane + v};
#pragma unroll 4
  for (int t = 0; t < B; ++t) {
    float in[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) in[p] = src[p][(size_t)t * V];
    if (t < 2)
      q.fill(in, t);
    else
      q.step(in, t);
  }
  q.drain(0, B);
  q.drain(1, B);
  finish(q, ph_out, pv_out, V, v);
}

// (2) the ring with the tick-order body (kFill 0), (3-6) with a skewed
// body (kFill 2)
template <class Body, int kFill>
__global__ void __launch_bounds__(oscen_stage::kBlock)
chain_ring(OSCEN_CHAIN_ARGS) {
  constexpr int kP = Body::kP;
  constexpr bool kDtP = kP == 6;
  extern __shared__ __align__(16) float smem[];
  const int l0 = blockIdx.x * kLanes;
  const int chunks = (B + kChunk - 1) / kChunk;
  if (threadIdx.x >= kLanes) {
    const size_t plane = (size_t)B * V;
    const float* planes[6] = {e3, e2, e1, dt, dt + plane, dt + 2 * plane};
    oscen_stage::Producer<kP> prod;
    prod.init(smem, planes, kP, V, B, l0);
    prod.run(chunks, [](int) {});
    return;
  }
  const int v = l0 + threadIdx.x;
  const bool live = v < V;
  Body q{};
  if (live) init<kDtP>(q, phases, prevs, dt, fb, mix, y, V, v);
  for (int c = 0; c < chunks; ++c) {
    oscen_stage::chunk_ready(c);
    if (live) {
      const float* src[kP];
      oscen_stage::stage_ptrs<kP>(smem, c, src);
      q.row0 = c * kChunk - kFill;
      oscen_stage::run_chunk<kP, kFill>(src, min(kChunk, B - c * kChunk), q,
                                        c == 0);
    }
    oscen_stage::chunk_done(c, chunks);
  }
  if (live) {
    if constexpr (kFill > 0) {
      q.drain(0, B);
      q.drain(1, B);
    }
    finish(q, ph_out, pv_out, V, v);
  }
}

template <class Body, int kFill>
cudaError_t launch_ring(OSCEN_CHAIN_ARGS, cudaStream_t st) {
  constexpr int kP = Body::kP;
  const cudaError_t err = oscen_stage::allow_ring<chain_ring<Body, kFill>>(kP);
  if (err != cudaSuccess) return err;
  chain_ring<Body, kFill><<<(V + kLanes - 1) / kLanes, oscen_stage::kBlock,
                            oscen_stage::ring_bytes(kP), st>>>(
      phases, prevs, dt, fb, mix, e3, e2, e1, y, ph_out, pv_out, V, B);
  return cudaGetLastError();
}

template <bool kPivot, bool kDtP>
cudaError_t launch_probe(int variant, OSCEN_CHAIN_ARGS, cudaStream_t st) {
#define R(Body, kFill)                                                      \
  launch_ring<Body, kFill>(phases, prevs, dt, fb, mix, e3, e2, e1, y,      \
                           ph_out, pv_out, V, B, st)
  using Tick = TickBody<kPivot, kDtP>;
  using Op3 = SkewBody<kPivot, kDtP, 1>;
  using NoRound = SkewBody<kPivot, kDtP, 2>;
  using NoWrap = SkewBody<kPivot, kDtP, 3>;
  using Skew = SkewBody<kPivot, kDtP, 0>;
  switch (variant) {
    case 1:
      chain_global<kPivot, kDtP><<<(V + 31) / 32, 32, 0, st>>>(
          phases, prevs, dt, fb, mix, e3, e2, e1, y, ph_out, pv_out, V, B);
      return cudaGetLastError();
    case 2: return R(Tick, 0);
    case 3: return R(Op3, 2);
    case 4: return R(NoRound, 2);
    case 5: return R(NoWrap, 2);
    case 6: return R(Skew, 2);
    default: return cudaErrorInvalidValue;
  }
#undef R
}

#undef OSCEN_CHAIN_ARGS

}  // namespace probe_fm

// ---- K9 / K14 probes --------------------------------------------------
namespace probe_k9 {

using oscen_stage::kChunk;
using oscen_stage::kLanes;
using oscen_stage::kStages;

// kSnap 0: no snap (probe only); 1: the reference's compare and select
// (iir.cu's)
template <int kSnap>
__device__ __forceinline__ float snap(float v) {
  if constexpr (kSnap == 0) {
    return v;
  } else {
    return fabsf(v) < 1e-15f ? 0.0f : v;
  }
}

#define OSCEN_BIQUAD_ARGS                                                   \
  const float *__restrict__ x, const float *__restrict__ b0,               \
      const float *__restrict__ b1, const float *__restrict__ b2,          \
      const float *__restrict__ a1, const float *__restrict__ a2,          \
      const float *__restrict__ v1_in, const float *__restrict__ v2_in,    \
      float *__restrict__ y, float *__restrict__ v1_out,                   \
      float *__restrict__ v2_out, int V, int B

// K9's old body; XC: x and the coefficients of step 0 from registers
template <int XC, int kSnap>
__global__ void __launch_bounds__(32)
biquad_old(OSCEN_BIQUAD_ARGS, int b0s, int b1s, int b2s, int a1s, int a2s) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  float v1 = v1_in[v];
  float v2 = v2_in[v];
  const float x0 = x[v], c00 = b0[v], c10 = b1[v], c20 = b2[v],
              d10 = a1[v], d20 = a2[v];
#pragma unroll 4
  for (int t = 0; t < B; ++t) {
    const size_t i = (size_t)t * V + v;
    const float xt = snap<kSnap>(XC ? x0 : x[i]);
    const float c0 = XC ? c00 : b0[(size_t)t * b0s + v];
    const float c1 = XC ? c10 : b1[(size_t)t * b1s + v];
    const float c2 = XC ? c20 : b2[(size_t)t * b2s + v];
    const float d1 = XC ? d10 : a1[(size_t)t * a1s + v];
    const float d2 = XC ? d20 : a2[(size_t)t * a2s + v];
    const float out = c0 * xt + v1;
    const float nv1 = c1 * xt - d1 * out + v2;
    v2 = snap<kSnap>(c2 * xt - d2 * out);
    v1 = snap<kSnap>(nv1);
    y[i] = out;
  }
  v1_out[v] = v1;
  v2_out[v] = v2;
}

// The ring's modes: 0 as iir.cu; 1 the chain warp reads no shared memory
// (its inputs are step 0's, from registers); 2 the producer copies nothing
// (the barriers alone; y stored).
template <int kMode>
__host__ __device__ constexpr bool reads_ring() { return kMode != 1; }

// The producer's run without copies (mode 2): Producer::run's barriers.
__device__ __forceinline__ void handover_only(int chunks) {
  for (int k = 0; k < chunks; ++k) {
    if (k >= kStages) oscen_stage::bar_sync(oscen_stage::empty_id(k));
    if (k >= 1) oscen_stage::bar_arrive(oscen_stage::full_id(k - 1));
  }
  oscen_stage::bar_arrive(oscen_stage::full_id(chunks - 1));
}

// the ring's step, every coefficient a plane: x, b0, b1, b2, a1, a2
template <int kSnap, int kMode>
struct RingBody {
  float v1, v2;
  float fixed[6];   // mode 1: the inputs
  float* y;
  int stride;
  __device__ __forceinline__ void step(const float (&staged)[6], int t) {
    float in[6];
#pragma unroll
    for (int p = 0; p < 6; ++p)
      in[p] = reads_ring<kMode>() ? staged[p] : fixed[p];
    const float xt = snap<kSnap>(in[0]);
    const float out = in[1] * xt + v1;
    const float nv1 = in[2] * xt - in[4] * out + v2;
    v2 = snap<kSnap>(in[3] * xt - in[5] * out);
    v1 = snap<kSnap>(nv1);
    y[t * stride] = out;
  }
};

template <int kSnap, bool kStageY, int kMode>
__global__ void __launch_bounds__(oscen_stage::kBlock)
biquad_ring(OSCEN_BIQUAD_ARGS) {
  static_assert(kMode != 2 || !kStageY, "mode 2 stores y");
  extern __shared__ __align__(16) float smem[];
  float* const y_slot = smem + 6 * oscen_stage::kSlotFloats;
  const int l0 = blockIdx.x * kLanes;
  const int chunks = (B + kChunk - 1) / kChunk;
  if (threadIdx.x >= kLanes) {
    const float* planes[6] = {x, b0, b1, b2, a1, a2};
    oscen_stage::Producer<6> prod;
    prod.init(smem, planes, 6, V, B, l0);
    if constexpr (kMode == 2)
      handover_only(chunks);
    else if constexpr (kStageY)
      prod.run_staged(chunks, y_slot, y, 0);
    else
      prod.run(chunks, [](int) {});
    return;
  }
  const int v = l0 + threadIdx.x;
  const bool live = v < V;
  RingBody<kSnap, kMode> body{};
  if (live) {
    body.v1 = v1_in[v];
    body.v2 = v2_in[v];
    const float* const first[6] = {x, b0, b1, b2, a1, a2};
#pragma unroll
    for (int p = 0; p < 6; ++p) body.fixed[p] = first[p][v];
  }
  for (int c = 0; c < chunks; ++c) {
    oscen_stage::chunk_ready(c);
    if (live) {
      const float* src[6];
      oscen_stage::stage_ptrs<6>(smem, c, src);
      if constexpr (kStageY) {
        body.y = y_slot + (c % kStages) * kChunk * kLanes + threadIdx.x;
        body.stride = kLanes;
      } else {
        body.y = y + (size_t)c * kChunk * V + v;
        body.stride = V;
      }
      oscen_stage::run_chunk<6>(src, min(kChunk, B - c * kChunk), body);
    }
    if constexpr (kStageY)
      oscen_stage::bar_arrive(oscen_stage::empty_id(c));
    else
      oscen_stage::chunk_done(c, chunks);
  }
  if (live) {
    v1_out[v] = body.v1;
    v2_out[v] = body.v2;
  }
}

template <int kSnap, bool kStageY, int kMode>
cudaError_t launch_ring(OSCEN_BIQUAD_ARGS, cudaStream_t st) {
  const cudaError_t err =
      oscen_stage::allow_ring<biquad_ring<kSnap, kStageY, kMode>>(7);
  if (err != cudaSuccess) return err;
  biquad_ring<kSnap, kStageY, kMode><<<(V + kLanes - 1) / kLanes,
                                       oscen_stage::kBlock,
                                       oscen_stage::ring_bytes(7), st>>>(
      x, b0, b1, b2, a1, a2, v1_in, v2_in, y, v1_out, v2_out, V, B);
  return cudaGetLastError();
}

#undef OSCEN_BIQUAD_ARGS

}  // namespace probe_k9

namespace probe_fm {

#define OSCEN_OPERATOR_ARGS                                                 \
  const float *__restrict__ phase0, const float *__restrict__ prev0,       \
      const float *__restrict__ dt, const float *__restrict__ pm,          \
      const float *__restrict__ fb, const float *__restrict__ env,         \
      const float *__restrict__ lvl, float *__restrict__ y,                \
      float *__restrict__ ph_out, float *__restrict__ pv_out, int V, int B

// K14's old body; XC: the five planes of step 0 from registers; LVL 0:
// without the * lvl
template <int XC, int LVL>
__global__ void __launch_bounds__(32) operator_old(OSCEN_OPERATOR_ARGS) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  float ph = phase0[v];
  float prev = prev0[v];
  const float dt0 = dt[v], pm0 = pm[v], fb0 = fb[v], env0 = env[v],
              lvl0 = lvl[v];
#pragma unroll 4
  for (int t = 0; t < B; ++t) {
    const size_t i = (size_t)t * V + v;
    const float total_pm = (XC ? pm0 : pm[i]) + prev * (XC ? fb0 : fb[i]);
    float out = sin_turns(ph + total_pm) * (XC ? env0 : env[i]);
    if (LVL) out = out * (XC ? lvl0 : lvl[i]);
    ph = fract_step(ph, XC ? dt0 : dt[i]);
    prev = out;
    y[i] = out;
  }
  ph_out[v] = ph;
  pv_out[v] = prev;
}

// fm.cu's lone-operator step on the ring: env, dt, pm, fb, lvl staged;
// kMode as biquad_ring's
template <int kMode>
struct OperatorBody {
  float ph, p;
  float fixed[5];   // mode 1: the inputs
  float* y;
  int stride;
  __device__ __forceinline__ void step(const float (&staged)[5], int t) {
    float in[5];
#pragma unroll
    for (int q = 0; q < 5; ++q)
      in[q] = probe_k9::reads_ring<kMode>() ? staged[q] : fixed[q];
    const float out = sin_turns(ph + (in[2] + p * in[3])) * in[0] * in[4];
    y[t * stride] = out;
    p = out;
    ph = fract_step(ph, in[1]);
  }
};

template <bool kStageY, int kMode>
__global__ void __launch_bounds__(oscen_stage::kBlock)
operator_ring(OSCEN_OPERATOR_ARGS) {
  static_assert(kMode != 2 || !kStageY, "mode 2 stores y");
  extern __shared__ __align__(16) float smem[];
  float* const y_slot = smem + 5 * oscen_stage::kSlotFloats;
  const int l0 = blockIdx.x * kLanes;
  const int chunks = (B + kChunk - 1) / kChunk;
  if (threadIdx.x >= kLanes) {
    const float* planes[5] = {env, dt, pm, fb, lvl};
    oscen_stage::Producer<5> prod;
    prod.init(smem, planes, 5, V, B, l0);
    if constexpr (kMode == 2)
      probe_k9::handover_only(chunks);
    else if constexpr (kStageY)
      prod.run_staged(chunks, y_slot, y, 0);
    else
      prod.run(chunks, [](int) {});
    return;
  }
  const int v = l0 + threadIdx.x;
  const bool live = v < V;
  OperatorBody<kMode> body{};
  if (live) {
    body.ph = phase0[v];
    body.p = prev0[v];
    const float* const first[5] = {env, dt, pm, fb, lvl};
#pragma unroll
    for (int q = 0; q < 5; ++q) body.fixed[q] = first[q][v];
  }
  for (int c = 0; c < chunks; ++c) {
    oscen_stage::chunk_ready(c);
    if (live) {
      const float* src[5];
      oscen_stage::stage_ptrs<5>(smem, c, src);
      if constexpr (kStageY) {
        body.y = y_slot + (c % oscen_stage::kStages) * kChunk * kLanes +
                 threadIdx.x;
        body.stride = kLanes;
      } else {
        body.y = y + (size_t)c * kChunk * V + v;
        body.stride = V;
      }
      oscen_stage::run_chunk<5>(src, min(kChunk, B - c * kChunk), body);
    }
    if constexpr (kStageY)
      oscen_stage::bar_arrive(oscen_stage::empty_id(c));
    else
      oscen_stage::chunk_done(c, chunks);
  }
  if (live) {
    ph_out[v] = body.ph;
    pv_out[v] = body.p;
  }
}

template <bool kStageY, int kMode>
cudaError_t launch_operator_ring(OSCEN_OPERATOR_ARGS, cudaStream_t st) {
  const cudaError_t err =
      oscen_stage::allow_ring<operator_ring<kStageY, kMode>>(6);
  if (err != cudaSuccess) return err;
  operator_ring<kStageY, kMode><<<(V + kLanes - 1) / kLanes,
                                  oscen_stage::kBlock,
                                  oscen_stage::ring_bytes(6), st>>>(
      phase0, prev0, dt, pm, fb, env, lvl, y, ph_out, pv_out, V, B);
  return cudaGetLastError();
}

#undef OSCEN_OPERATOR_ARGS

}  // namespace probe_fm

// K17 direct's body into [B, 3, V] (K12_LAYOUT 0) or [3, B, V] (1)
template <int K12_LAYOUT>
__global__ void __launch_bounds__(32)
fract_direct_probe(const float* __restrict__ phases,
                   const float* __restrict__ dt, float* __restrict__ out,
                   float* __restrict__ carry, int V, int B) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 3 * V) return;
  float p = phases[i];
  const float d = dt[i];
  const int r = i / V;
  float* o = K12_LAYOUT ? out + (size_t)r * B * V + (i - r * V) : out + i;
  const size_t stride = K12_LAYOUT ? (size_t)V : (size_t)3 * V;
  if (__float_as_uint(p) < 0x3F800000u && __float_as_uint(d) < 0x3F800000u) {
#pragma unroll 8
    for (int t = 0; t < B; ++t) {
      o[(size_t)t * stride] = p;
      p = oscen_wrap::short_wrap(p + d);
    }
  } else {
#pragma unroll 8
    for (int t = 0; t < B; ++t) {
      o[(size_t)t * stride] = p;
      const float q = p + d;
      p = q - truncf(q);
    }
  }
  carry[i] = p;
}

extern "C" {

int probe_fract_direct(int k12_layout, const float* phases, const float* dt,
                       float* out, float* carry, int V, int B,
                       void* stream) {
  const dim3 grid((3 * V + 31) / 32);
  cudaStream_t st = (cudaStream_t)stream;
  if (k12_layout)
    fract_direct_probe<1><<<grid, 32, 0, st>>>(phases, dt, out, carry, V, B);
  else
    fract_direct_probe<0><<<grid, 32, 0, st>>>(phases, dt, out, carry, V, B);
  return (int)cudaGetLastError();
}

int probe_phase(int variant, const float* phase0, const float* dt,
                float* before, float* carry, int V, int B, void* stream) {
  const dim3 grid((V + 31) / 32);
  cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {
    case 0:   // (a) as is
      phase_probe<0><<<grid, 32, 0, st>>>(phase0, dt, before, carry, V, B);
      break;
    case 1:   // (b) dt from a register
      phase_probe<1><<<grid, 32, 0, st>>>(phase0, dt, before, carry, V, B);
      break;
    case 2:   // (c) the new ring with floorf
      phase_ring_floor<<<grid, oscen_stage::kBlock,
                         oscen_stage::ring_bytes(1), st>>>(phase0, dt, before,
                                                           carry, V, B);
      break;
    default: return 1;
  }
  return (int)cudaGetLastError();
}

int probe_tpt(int variant, const float* x, const float* h, const float* g,
              const float* k, const float* z0, const float* z1, float* y,
              float* z0o, float* z1o, int V, int B, int hs, int gs, int ks,
              void* stream) {
  const dim3 grid((V + 31) / 32);
  cudaStream_t st = (cudaStream_t)stream;
#define L(XC, U) tpt_probe<XC, U><<<grid, 32, 0, st>>>(x, h, g, k, z0, z1, y, \
                                                       z0o, z1o, V, B, hs, gs, ks)
  switch (variant) {
    case 0: L(0, 4); break;
    case 1: L(1, 4); break;
    case 2: L(0, 16); break;
    case 3: L(0, 1); break;
    default: return 1;
  }
#undef L
  return (int)cudaGetLastError();
}

int probe_lp18(int variant, const float* x, const float* g, const float* h,
               const float* z, float* y, float* zo, int V, int B, int gs,
               int hs, void* stream) {
  const dim3 grid((V + 31) / 32);
  cudaStream_t st = (cudaStream_t)stream;
#define L(XC, T, D, U) lp18_probe<XC, T, D, U><<<grid, 32, 0, st>>>( \
    x, g, h, z, y, zo, V, B, gs, hs)
  switch (variant) {
    case 0: L(0, 1, 1, 4); break;   // (a) as is
    case 1: L(1, 1, 1, 4); break;   // (b) x from a register
    case 2: L(0, 0, 1, 4); break;   // (c) tanh -> identity
    case 3: L(0, 1, 0, 4); break;   // (d) division -> product
    case 4: L(1, 0, 0, 4); break;   // (b+c+d) the bare chain
    case 5: L(0, 1, 1, 16); break;  // unroll 16
    case 6: L(0, 0, 0, 4); break;   // (c+d) loads, no tanh, no division
    default: return 1;
  }
#undef L
  return (int)cudaGetLastError();
}

// K13 (pivot 0) / K15 (pivot 1) as one warp per 32 lanes: variant 1
// skewed by a sample, inputs from global memory; 2 tick order on the
// ring; 6 skewed by a sample on the ring; 3 op3 alone, 4 (6) with the
// sine unrounded, 5 (6) without the wraps (3-5 compute other numbers);
// the arguments of oscen_pivot_chain3_scan.
int probe_chain(int variant, int pivot, const float* phases,
                const float* prevs, const float* dt, const float* fb,
                const float* mix, const float* e3, const float* e2,
                const float* e1, float* y, float* ph_out, float* pv_out,
                int V, int B, int dt_stride, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const bool dtp = dt_stride != 0;
#define L(P, D)                                                             \
  probe_fm::launch_probe<P, D>(variant, phases, prevs, dt, fb, mix, e3, e2, \
                               e1, y, ph_out, pv_out, V, B, st)
  const cudaError_t err = pivot ? (dtp ? L(true, true) : L(true, false))
                                : (dtp ? L(false, true) : L(false, false));
#undef L
  return (int)err;
}

// K9: variants 0-3 the old body (0 as is, 1 x and the coefficients from
// registers, 2 without snaps, 3 both), 4-8 the ring with every coefficient
// a plane (4 no snaps, 5 y stored, 6 iir.cu's body, 7 the chain warp reads
// no shared memory, 8 the producer copies nothing); the arguments of
// oscen_biquad_scan.
int probe_biquad(int variant, const float* x, const float* b0,
                 const float* b1, const float* b2, const float* a1,
                 const float* a2, const float* v1, const float* v2, float* y,
                 float* v1o, float* v2o, int V, int B, int b0s, int b1s,
                 int b2s, int a1s, int a2s, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const bool planes = b0s && b1s && b2s && a1s && a2s;
  if (variant >= 4 && !planes) return (int)cudaErrorInvalidValue;
#define L(XC, S)                                                            \
  probe_k9::biquad_old<XC, S><<<(V + 31) / 32, 32, 0, st>>>(               \
      x, b0, b1, b2, a1, a2, v1, v2, y, v1o, v2o, V, B, b0s, b1s, b2s, a1s, \
      a2s)
#define R(S, Y, M)                                                          \
  return (int)probe_k9::launch_ring<S, Y, M>(x, b0, b1, b2, a1, a2, v1, v2, \
                                             y, v1o, v2o, V, B, st)
  switch (variant) {
    case 0: L(0, 1); break;
    case 1: L(1, 1); break;
    case 2: L(0, 0); break;
    case 3: L(1, 0); break;
    case 4: R(0, true, 0);
    case 5: R(1, false, 0);
    case 6: R(1, true, 0);
    case 7: R(1, true, 1);
    case 8: R(1, false, 2);
    default: return (int)cudaErrorInvalidValue;
  }
#undef L
#undef R
  return (int)cudaGetLastError();
}

// K14: variants 0-3 the old body (0 as is, 1 the planes from registers, 2
// without * lvl, 3 both), 4-7 the ring (4 y stored, 5 fm.cu's body, 6 the
// chain warp reads no shared memory, 7 the producer copies nothing); the
// arguments of oscen_fm_operator_scan.
int probe_operator(int variant, const float* phase0, const float* prev0,
                   const float* dt, const float* pm, const float* fb,
                   const float* env, const float* lvl, float* y,
                   float* ph_out, float* pv_out, int V, int B,
                   void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
#define L(XC, LV)                                                           \
  probe_fm::operator_old<XC, LV><<<(V + 31) / 32, 32, 0, st>>>(            \
      phase0, prev0, dt, pm, fb, env, lvl, y, ph_out, pv_out, V, B)
#define R(Y, M)                                                             \
  return (int)probe_fm::launch_operator_ring<Y, M>(                        \
      phase0, prev0, dt, pm, fb, env, lvl, y, ph_out, pv_out, V, B, st)
  switch (variant) {
    case 0: L(0, 1); break;
    case 1: L(1, 1); break;
    case 2: L(0, 0); break;
    case 3: L(1, 0); break;
    case 4: R(false, 0);
    case 5: R(true, 0);
    case 6: R(true, 1);
    case 7: R(false, 2);
    default: return (int)cudaErrorInvalidValue;
  }
#undef L
#undef R
  return (int)cudaGetLastError();
}

}  // extern "C"

// latency of dependent chains, cycles per op (clock64), one thread
__global__ void lat_kernel(float* out, long long* cyc, float seed, int n) {
  __shared__ int tbl[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) tbl[i] = (i * 7 + 1) & 255;
  __syncthreads();
  if (threadIdx.x) return;
  float f = seed; double d = seed; int j = (int)seed;
  long long t0 = clock64();
  for (int i = 0; i < n; ++i) f = f * 0.999f + 0.5f;          // FMUL+FADD (fmad off)
  long long t1 = clock64();
  for (int i = 0; i < n; ++i) d = __fma_rn(d, 0.999, 0.5);     // DFMA
  long long t2 = clock64();
  for (int i = 0; i < n; ++i) f = (float)((double)f + 1e-30);  // F2F, DADD, F2F
  long long t3 = clock64();
  for (int i = 0; i < n; ++i) j = tbl[j];                       // LDS
  long long t4 = clock64();
  for (int i = 0; i < n; ++i) d = __dmul_rn(d, 1.0000001);      // DMUL
  long long t5 = clock64();
  float q = f;
  for (int i = 0; i < n; ++i) q = 1.0f / (q + 1.5f);            // IEEE div
  long long t6 = clock64();
  // K6's wrap chains, one step each (values cycle in [0, 1))
  float r = q - floorf(q);
  for (int i = 0; i < n; ++i) {                                 // FADD,
    r = r + 0.37f;                                              // FRND.FLOOR,
    r = r - floorf(r);                                          // FADD
  }
  long long t7 = clock64();
  for (int i = 0; i < n; ++i) {                                 // FADD, FSETP,
    const float u = r + 0.37f;                                  // FSEL, FADD
    r = u + (u >= 1.0f ? -1.0f : 0.0f);
  }
  long long t8 = clock64();
  for (int i = 0; i < n; ++i) {                                 // FADD, FSETP
    const float u = r + 0.37f;                                  // and FADD,
    r = u >= 1.0f ? u - 1.0f : u;                               // FSEL
  }
  long long t9 = clock64();
  for (int i = 0; i < n; ++i) {                                 // FADD, FSET,
    const float u = r + 0.37f;                                  // FADD
    float c;
    asm("set.ge.f32.f32 %0, %1, 0f3F800000;" : "=f"(c) : "f"(u));
    r = u - c;
  }
  long long t10 = clock64();
  out[0] = f + (float)d + j + q + r;
  cyc[0] = t1 - t0; cyc[1] = t2 - t1; cyc[2] = t3 - t2; cyc[3] = t4 - t3;
  cyc[4] = t5 - t4; cyc[5] = t6 - t5; cyc[6] = t7 - t6; cyc[7] = t8 - t7;
  cyc[8] = t9 - t8; cyc[9] = t10 - t9;
}

extern "C" int probe_lat(float* out, long long* cyc, int n) {
  lat_kernel<<<1, 32>>>(out, cyc, 1.25f, n);
  return (int)cudaGetLastError();
}
