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
// The tanh is (float)tanh((double)b), the float64 tanh rounded once, the
// value ops/fmath.py::tanh gives on the CPU and on the card (float32 tanh
// differs between PyTorch's CPU and CUDA builds).  The quotient is the
// correctly rounded IEEE quotient.  Both are computed by short exact paths
// (below); the kernel's output equals the plain version bit for bit.
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
// a template parameter, 1 to 8), its stages skewed in time (the design is
// above the kernel).  The wrapper may put both branches of one halfband
// stage side by side as lanes, each with its own betas in a [S, V].
//
// Layout: one thread per voice lane; the filter state stays in registers
// for the whole block.  x and y are time-major [B, V] (a warp's loads and
// stores of one time step are coalesced).  Every coefficient is either a
// [V] row, block-constant (time stride 0, loaded once), or a [B, V]
// per-sample plane (time stride V): the caller passes each one's time
// stride, so one kernel serves both forms.
//
// What bounds them on the card: each recurrence is serial in time (about
// 9 dependent float ops per sample for the TPT and the biquad, 13 plus the
// tanh for the LP18, 3 * S for the allpass cascade), and 256 voices are 8
// warps for 132 SMs; the twin-peaks filter is 1 or 2 lanes of one warp, the
// oversampled saturator's resampler 2 (one per branch).  So every kernel is
// bound by the latency of that chain (its chain floor: steps x dependent
// ops x their latency), far above the bytes it moves (8 bytes per sample
// and lane, up to 28 with per-sample coefficients).  One chain warp per
// CUDA block spreads the warps over SMs, and each adds a producer warp.
// The true block length B bounds the loop; any B >= 1 and any V work.
//
// K7 to K10 keep their loads off the chain: x and every per-sample
// coefficient plane come through the staged ring of scan_stage.cuh (a
// producer warp's cp.async, up to two 32-step chunks ahead, handed over by
// named barriers), so the chain warp reads shared memory a group of 8
// steps ahead of the steps that use it.  K8 also shortens its chain:
// - the division: rd = 1 / (1 + g) in float64 does not depend on the
//   state, so it is computed once per lane for rows and by the producer
//   for planes; the quotient is the float64 product a * rd rounded once,
//   the correctly rounded a / d for every float a when d is in [1, 4)
//   (div_by has the argument).  The twin peaks' d = 1 + tan(pi fc) lies in
//   [1.003, 2.61].  Markstein's float32 correction of a * r would be 3
//   float ops instead of 2 conversions and a product, but it is exact only
//   for |a| above ~2^-100, and a silent input leaves the LP18 in a
//   denormal limit cycle (its state stays near 1e-44), so it would need a
//   guard on every step;
// - the tanh: tanh_exact_fast (below) evaluates a short float64
//   polynomial from a table and applies Ziv's rounding test; a chunk in
//   which a lane's test could not decide (about 1 in 10^6 samples, every
//   NaN, and a d outside [1, 4)) is run again from its saved state with
//   the reference body, (float)tanh((double)b) and the true `/`, so the
//   test never sits on the chain.
// K10 also skews its stages in time, so its step's chain is one stage's 3
// ops instead of S stages' (below).
//
// Numerics: built with --fmad=false and without fast-math, so every product
// and sum rounds as PyTorch's separate elementwise ops do, and every output
// equals the plain PyTorch version bit for bit.  Denormals are kept
// (nvcc's default -ftz=false), as on the CPU; the TPU flushed them.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include "scan_stage.cuh"
#include "tanh_table.cuh"

namespace {

using oscen_stage::kChunk;
using oscen_stage::kLanes;
using oscen_stage::kStages;
using oscen_stage::run_chunk;
using oscen_stage::stage_ptrs;

// A coefficient at this step: staged input i, or the row.
template <bool kStaged, int kP>
__device__ __forceinline__ float pick(const float (&in)[kP], int i,
                                      float row) {
  if constexpr (kStaged) {
    return in[i];
  } else {
    return row;
  }
}

// K7's step on staged inputs: x, then h, g, k each staged (kHP, kGP, kKP)
// or a row.
template <bool kHP, bool kGP, bool kKP>
struct TptBody {
  static constexpr int kP = 1 + kHP + kGP + kKP;
  float h, g, k;     // rows
  float z0, z1;
  float* y;          // this lane's y at the chunk's first step
  int V;
  __device__ __forceinline__ void step(const float (&in)[kP], int t) {
    const float xt = in[0];
    const float ht = pick<kHP>(in, 1, h);
    const float gt = pick<kGP>(in, 1 + kHP, g);
    const float kt = pick<kKP>(in, 1 + kHP + kGP, k);
    const float high = (xt - z0 * kt - z1) * ht;
    const float band = high * gt + z0;
    const float low = band * gt + z1;
    z0 = high * gt + band;
    z1 = band * gt + low;
    y[t * V] = low;
  }
};

template <bool kHP, bool kGP, bool kKP>
__global__ void __launch_bounds__(oscen_stage::kBlock)
tpt_svf_kernel(const float* __restrict__ x, const float* __restrict__ h,
               const float* __restrict__ g, const float* __restrict__ k,
               const float* __restrict__ z0_in,
               const float* __restrict__ z1_in, float* __restrict__ y,
               float* __restrict__ z0_out, float* __restrict__ z1_out,
               int V, int B) {
  using Body = TptBody<kHP, kGP, kKP>;
  constexpr int kP = Body::kP;
  extern __shared__ __align__(16) float smem[];
  const int l0 = blockIdx.x * kLanes;
  const int chunks = (B + kChunk - 1) / kChunk;
  if (threadIdx.x >= kLanes) {   // the producer warp
    const float* planes[4] = {x};
    int n = 1;
    if constexpr (kHP) planes[n++] = h;
    if constexpr (kGP) planes[n++] = g;
    if constexpr (kKP) planes[n++] = k;
    oscen_stage::Producer<kP> prod;
    prod.init(smem, planes, kP, V, B, l0);
    prod.run(chunks, [](int) {});
    return;
  }
  const int v = l0 + threadIdx.x;
  const bool live = v < V;   // every thread syncs; live ones scan
  Body body{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, nullptr, V};
  if (live) {
    if constexpr (!kHP) body.h = h[v];
    if constexpr (!kGP) body.g = g[v];
    if constexpr (!kKP) body.k = k[v];
    body.z0 = z0_in[v];
    body.z1 = z1_in[v];
  }
  for (int c = 0; c < chunks; ++c) {
    oscen_stage::chunk_ready(c);
    if (live) {
      const float* src[kP];
      stage_ptrs<kP>(smem, c, src);
      body.y = y + (size_t)c * kChunk * V + v;
      run_chunk<kP>(src, min(kChunk, B - c * kChunk), body);
    }
    oscen_stage::chunk_done(c, chunks);
  }
  if (live) {
    z0_out[v] = body.z0;
    z1_out[v] = body.z1;
  }
}

// (float)tanh((double)b), libdevice's float64 tanh rounded once, on a short
// path (ops/cuda/tanh_table.py has the table, its error and a numpy model):
// a = |b| past the saturation threshold gives +-1; else interval
// i = round(16 min(a, 9)) (0 .. OSCEN_TANH_INTERVALS - 1, the last bits of
// the float32 sum min(a, 9) + 2^19, which also address the table row),
// r = a - i/16 exact in float32, and the degree-7 float64 polynomial in r
// of row i of `tab` (the shared address of kTanhCoef as stage_tanh_table
// stages it, a row every 256 bytes) by Estrin's scheme; row 0
// is odd with linear term 1, so tiny a keep their relative accuracy.  The
// value t rounds to y = (float)t, signed as b.  Ziv's test reads
// t's bits: the 29 low bits of its significand are the part below y's
// last place, and the float64 tanh rounds to y too unless they lie within
// OSCEN_TANH_MARGIN units of the half-way pattern 2^28 (the table's error,
// the evaluation's and libdevice's come to under 30 units; t in the float32
// denormal range is always a float32 itself, tanh(a) = a there).
// `undecided` is set where the test fails or t is NaN: the caller then
// takes the reference.  No branch: the two lanes of the fused twin peaks
// stay together, and the test is off the chain (only `undecided` depends on
// it).
__device__ __forceinline__ float tanh_exact_fast(float b, unsigned tab,
                                                 bool& undecided) {
  const float a = fabsf(b);
  const float f = fminf(a, 9.0f) + 0x1p19f;
  const float center = f - 0x1p19f;
  const float r = a - center;
  // f's bits are 0x49000000 + i: shifted by 8, the exponent leaves the
  // word and i * 256 remains, the offset of row i (rows 256 bytes apart)
  const unsigned row = tab + (__float_as_uint(f) << 8);
  double c0, c1, c2, c3, c4, c5, c6, c7;
  asm volatile("ld.shared.v2.f64 {%0, %1}, [%2];"
               : "=d"(c0), "=d"(c1) : "r"(row));
  asm volatile("ld.shared.v2.f64 {%0, %1}, [%2+16];"
               : "=d"(c2), "=d"(c3) : "r"(row));
  asm volatile("ld.shared.v2.f64 {%0, %1}, [%2+32];"
               : "=d"(c4), "=d"(c5) : "r"(row));
  asm volatile("ld.shared.v2.f64 {%0, %1}, [%2+48];"
               : "=d"(c6), "=d"(c7) : "r"(row));
  const double u = (double)r;   // r = a in interval 0
  const double u2 = __dmul_rn(u, u);
  const double p01 = __fma_rn(c1, u, c0);
  const double p23 = __fma_rn(c3, u, c2);
  const double p45 = __fma_rn(c5, u, c4);
  const double p67 = __fma_rn(c7, u, c6);
  const double lo = __fma_rn(p23, u2, p01);
  const double hi = __fma_rn(p67, u2, p45);
  const double t = __fma_rn(hi, __dmul_rn(u2, u2), lo);   // tanh(a) >= 0
  const float y = __double2float_rn(t);
  const bool sat = a >= OSCEN_TANH_SATURATION;
  const int below = (int)((unsigned)__double2loint(t) & 0x1fffffffu);
  const bool near = abs(below - 0x10000000) < OSCEN_TANH_MARGIN;
  // bitwise, not && / ||: a short circuit would branch inside the chain
  undecided |= !sat & (near | isnan(t));
  return copysignf(sat ? 1.0f : y, b);   // -0 keeps its sign
}

// kTanhCoef in shared memory as tanh_exact_fast reads it: row i at
// 256 * i bytes (its 64 bytes, then padding).
constexpr int kTanhRowDoubles = 32;
constexpr int kTanhTabDoubles = OSCEN_TANH_INTERVALS * kTanhRowDoubles;

// Stage kTanhCoef into shared memory `tab` with 16-byte cp.async by
// `threads` threads, this one number `i` (the caller commits, waits and
// syncs); returns its shared address for tanh_exact_fast.
__device__ __forceinline__ unsigned stage_tanh_table(double* tab, int i,
                                                     int threads) {
  constexpr int kPieces = OSCEN_TANH_INTERVALS * 4;   // 16 bytes each
  for (int p = i; p < kPieces; p += threads)
    oscen_stage::cp_async16(tab + (p / 4) * kTanhRowDoubles + 2 * (p % 4),
                            kTanhCoef + 2 * p);
  return (unsigned)__cvta_generic_to_shared(tab);
}

// a / d, correctly rounded, from rd = 1 / d in float64 (to 2^-53), for d
// in [1, 4): the float64 product a * rd is within 2^-52 of a / d, and
// a / d lies either on a float32 (or denormal) rounding boundary exactly,
// which only d = 2 reaches (an exact product), or at least 2^-49 of it
// away (a and d have 24-bit significands), so rounding the product once
// more gives the true quotient, for zero, denormal, huge and infinite a
// too.  Branch-free; for d outside [1, 4) rd is NaN (div_rd), so the step
// turns NaN and the chunk re-runs with the true `/`.
__device__ __forceinline__ float div_by(float a, double rd) {
  return __double2float_rn(__dmul_rn((double)a, rd));
}

// rd for div_by: 1 / d in float64, or NaN where d is outside [1, 4).  The
// float32 approximate reciprocal (2^-22) and two Newton steps in float64
// (2^-44, then within 2^-53 of 1 / d): no division, no branch.
__device__ __forceinline__ double div_rd(float d) {
  float r0;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r0) : "f"(d));
  const double dd = (double)d;
  double r = (double)r0;
  r = __fma_rn(r, __fma_rn(-dd, r, 1.0), r);
  r = __fma_rn(r, __fma_rn(-dd, r, 1.0), r);
  return (d >= 1.0f) & (d < 4.0f) ? r : __longlong_as_double(0x7ff8000000000000ll);
}

// K8's step on staged inputs: x, then g and h each staged (kGP, kHP) or a
// row; rd = 1 / (1 + g) in float64 (div_rd), a row or, with a per-sample
// g, the producer's plane at `rdp`.  `step` runs the short paths and flags
// an undecided tanh (NaN included: a d outside [1, 4) makes the step NaN);
// `reference` is the plain version's arithmetic, for a chunk with an
// undecided lane.
template <bool kGP, bool kHP>
struct Lp18Body {
  static constexpr int kP = 1 + kGP + kHP;
  float g, h;         // rows
  double rd;          // row
  float z0, z1, z2;
  float* y;           // this lane's y at the chunk's first step
  const double* rdp;  // this lane's rd at the chunk's first step
  int V;
  unsigned tab;       // kTanhCoef in shared memory (stage_tanh_table)
  bool undecided;
  __device__ __forceinline__ void step(const float (&in)[kP], int t) {
    const float xt = in[0];
    const float gt = pick<kGP>(in, 1, g);
    const float ht = pick<kHP>(in, 1 + kGP, h);
    double rdt = rd;
    if constexpr (kGP) rdt = rdp[t * kLanes];
    const float hp = div_by(xt - ht * z0 - z1 - z2, rdt);
    const float bp1 = gt * hp + z0;
    z0 = tanh_exact_fast(bp1, tab, undecided);
    const float bp2 = gt * bp1 + z1;
    z1 = bp2;
    z2 = gt * bp2 + z2;
    y[t * V] = z2;
  }
  __device__ __forceinline__ void reference(const float (&in)[kP], int t) {
    const float xt = in[0];
    const float gt = pick<kGP>(in, 1, g);
    const float ht = pick<kHP>(in, 1 + kGP, h);
    const float hp = (xt - ht * z0 - z1 - z2) / (1.0f + gt);
    const float bp1 = gt * hp + z0;
    z0 = (float)tanh((double)bp1);
    const float bp2 = gt * bp1 + z1;
    z1 = bp2;
    z2 = gt * bp2 + z2;
    y[t * V] = z2;
  }
};

template <bool kGP, bool kHP>
__global__ void __launch_bounds__(oscen_stage::kBlock)
lp18_kernel(const float* __restrict__ x, const float* __restrict__ g,
            const float* __restrict__ h, const float* __restrict__ z_in,
            float* __restrict__ y, float* __restrict__ z_out, int V, int B) {
  using Body = Lp18Body<kGP, kHP>;
  constexpr int kP = Body::kP;
  // dynamic shared memory: kP float slots, then (per-sample g) the
  // producer's float64 rd plane [kStages][kChunk][kLanes]
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(16) double tab[kTanhTabDoubles];
  double* rds = reinterpret_cast<double*>(smem + kP * oscen_stage::kSlotFloats);
  const int l0 = blockIdx.x * kLanes;
  const int chunks = (B + kChunk - 1) / kChunk;
  if (threadIdx.x >= kLanes) {   // the producer warp
    const float* planes[3] = {x};
    int n = 1;
    if constexpr (kGP) planes[n++] = g;
    if constexpr (kHP) planes[n++] = h;
    oscen_stage::Producer<kP> prod;
    prod.init(smem, planes, kP, V, B, l0);
    stage_tanh_table(tab, prod.lane, kLanes);   // lands with chunk 0 (FULL)
    prod.run(chunks, [&](int k) {
      if constexpr (kGP) {   // the chunk's 1 / (1 + g), off the chain
        const int off = (k % oscen_stage::kStages) * kChunk * kLanes +
                        prod.lane;
        const int n_steps = min(kChunk, B - k * kChunk);
        if (prod.lane < prod.W)
          for (int t = 0; t < n_steps; ++t)
            rds[off + t * kLanes] =
                div_rd(1.0f + smem[oscen_stage::kSlotFloats + off +
                                   t * kLanes]);
      }
    });
    return;
  }
  const int v = l0 + threadIdx.x;
  const bool live = v < V;   // every thread syncs; live ones scan
  Body body{0.0f, 0.0f, 0.0, 0.0f, 0.0f, 0.0f, nullptr, nullptr, V,
            (unsigned)__cvta_generic_to_shared(tab), false};
  if (live) {
    if constexpr (!kGP) {
      body.g = g[v];
      body.rd = div_rd(1.0f + body.g);   // 1 / (1 + g) once for a row
    }
    if constexpr (!kHP) body.h = h[v];
    body.z0 = z_in[v];
    body.z1 = z_in[V + v];
    body.z2 = z_in[2 * V + v];
  }
  for (int c = 0; c < chunks; ++c) {
    oscen_stage::chunk_ready(c);
    if (live) {
      const float* src[kP];
      stage_ptrs<kP>(smem, c, src);
      const int n_steps = min(kChunk, B - c * kChunk);
      body.y = y + (size_t)c * kChunk * V + v;
      body.rdp = rds + (c % oscen_stage::kStages) * kChunk * kLanes +
                 threadIdx.x;
      const float s0 = body.z0, s1 = body.z1, s2 = body.z2;
      body.undecided = false;
      run_chunk<kP>(src, n_steps, body);
      if (body.undecided) {   // rare: the chunk again, the reference body
        body.z0 = s0;
        body.z1 = s1;
        body.z2 = s2;
        for (int t = 0; t < n_steps; ++t) {
          float in[kP];
#pragma unroll
          for (int p = 0; p < kP; ++p) in[p] = src[p][t * kLanes];
          body.reference(in, t);
        }
      }
    }
    oscen_stage::chunk_done(c, chunks);
  }
  if (live) {
    z_out[v] = body.z0;
    z_out[V + v] = body.z1;
    z_out[2 * V + v] = body.z2;
  }
}

// Card checks of K8's two short paths (tests and chip_smoke.py); the
// sweeps walk all 2^32 float32 bit patterns over a grid-stride loop.
constexpr int kSweepBlocks = 132 * 16, kSweepThreads = 256;

// Stage the table for a whole block of kSweepThreads.
__device__ __forceinline__ unsigned stage_tanh_table_block(double* tab) {
  const unsigned at = stage_tanh_table(tab, threadIdx.x, kSweepThreads);
  oscen_stage::commit();
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  return at;
}

// tanh_exact_sweep: counts[0] += patterns whose tanh_exact differs from
// (float)tanh((double)b) (NaN equal to NaN), counts[1] += patterns the
// rounding test left undecided, counts[2] = min(counts[2], the smallest
// differing pattern).
__global__ void __launch_bounds__(kSweepThreads)
tanh_exact_sweep(unsigned long long* counts) {
  __shared__ __align__(16) double tab[kTanhTabDoubles];
  const unsigned at = stage_tanh_table_block(tab);
  unsigned long long wrong = 0, undecided_n = 0, first = ~0ull;
  const unsigned long long stride =
      (unsigned long long)kSweepBlocks * kSweepThreads;
  for (unsigned long long k = blockIdx.x * kSweepThreads + threadIdx.x;
       k < (1ull << 32); k += stride) {
    const float b = __uint_as_float((unsigned)k);
    bool undecided = false;
    float fast = tanh_exact_fast(b, at, undecided);
    const float ref = (float)tanh((double)b);
    if (undecided) fast = ref;
    if (__float_as_uint(fast) != __float_as_uint(ref) &&
        !(isnan(fast) && isnan(ref))) {
      ++wrong;
      first = min(first, k);
    }
    undecided_n += undecided;
  }
  for (int o = 16; o > 0; o /= 2) {
    wrong += __shfl_down_sync(0xffffffffu, wrong, o);
    undecided_n += __shfl_down_sync(0xffffffffu, undecided_n, o);
    first = min(first, __shfl_down_sync(0xffffffffu, first, o));
  }
  if ((threadIdx.x & 31) == 0) {
    if (wrong) {
      atomicAdd(&counts[0], wrong);
      atomicMin(&counts[2], first);
    }
    if (undecided_n) atomicAdd(&counts[1], undecided_n);
  }
}

// tanh_exact_map: y = tanh_exact(b) elementwise; counts[1] += the inputs
// its rounding test left undecided (then y is the reference's value).
__global__ void __launch_bounds__(kSweepThreads)
tanh_exact_map(const float* __restrict__ b, float* __restrict__ y, int n,
               unsigned long long* counts) {
  __shared__ __align__(16) double tab[kTanhTabDoubles];
  const unsigned at = stage_tanh_table_block(tab);
  const int k = blockIdx.x * kSweepThreads + threadIdx.x;
  bool undecided = false;
  if (k < n) {
    float v = tanh_exact_fast(b[k], at, undecided);
    if (undecided) v = (float)tanh((double)b[k]);
    y[k] = v;
  }
  const unsigned u = __ballot_sync(0xffffffffu, undecided);
  if ((threadIdx.x & 31) == 0 && u)
    atomicAdd(&counts[1], (unsigned long long)__popc(u));
}

// div_sweep: every finite float32 a against each of the nd divisors;
// counts[0] += pairs where K8's division differs from a / d (bit patterns:
// -0 and +0 differ).
__global__ void __launch_bounds__(kSweepThreads)
div_sweep(const float* __restrict__ ds, int nd, unsigned long long* counts) {
  unsigned long long wrong = 0;
  const unsigned long long stride =
      (unsigned long long)kSweepBlocks * kSweepThreads;
  for (unsigned long long k = blockIdx.x * kSweepThreads + threadIdx.x;
       k < (1ull << 32); k += stride) {
    const float a = __uint_as_float((unsigned)k);
    if (!isfinite(a)) continue;
    for (int j = 0; j < nd; ++j) {
      // as lp18_kernel: the short path, or (d outside [1, 4)) the re-run's
      // true quotient
      const float d = ds[j];
      const double rd = div_rd(d);
      const float q = isnan(rd) ? a / d : div_by(a, rd);
      wrong += __float_as_uint(q) != __float_as_uint(a / d);
    }
  }
  for (int o = 16; o > 0; o /= 2)
    wrong += __shfl_down_sync(0xffffffffu, wrong, o);
  if ((threadIdx.x & 31) == 0 && wrong) atomicAdd(&counts[0], wrong);
}

// K9.  What bounds it: the recurrence is serial in time, and the IIR lowpass
// runs it on one lane (V = number of instances, 1 in a graph) with five
// per-sample coefficient planes, so one warp on one SM does all the work:
// latency, not bytes (28 bytes per sample and lane).  The loop-carried
// cycle is v1's: + v1, * a1, -, + v2 and the snap (v2's own cycle, * a2,
// -, the snap, is shorter and runs beside it); everything that reads only
// x and the coefficients (the snap of x, b0 x, b1 x, b2 x) is off it.  The
// design:
//  - x and every per-sample plane through the staged ring (scan_stage.cuh:
//    a producer warp's cp.async, 4-byte copies at V = 1, 16-byte pieces
//    for aligned 32-lane rows), read a group of 8 steps ahead; rows stay
//    in registers.  Two instances: every coefficient a row, or every one
//    a plane (the IIR lowpass's form); the wrapper (ops/cuda/iir.py)
//    expands the rows of a mixed call into planes on the card.
//  - y staged in a shared slot and written back by the producer
//    (Producer::run_staged), so the chain warp's stream holds no global
//    stores: ~14 cycles a step faster than the chain warp's own stores at
//    V = 1, ~16 slower at V = 256 with planes (tools/scanprobe.py; PERF.md,
//    PR 11); one path, the IIR lowpass's.
//  - the snaps stay the reference's compare and select (FSETP, SEL): the
//    ring, not the chain, bounds the step (tools/scanprobe.py: the ring
//    without snaps takes as long; PERF.md, PR 11), and ptxas compiles a
//    mask form (set.lt.u32.f32, and-not) to the same FSETP and SEL.
__device__ __forceinline__ float snap(float v) {
  return fabsf(v) < 1e-15f ? 0.0f : v;
}

// K9's step on staged inputs: x, then (kPlanes) b0, b1, b2, a1, a2, or
// the five rows from registers; y into the chunk's stage of the y slot.
template <bool kPlanes>
struct BiquadBody {
  static constexpr int kP = kPlanes ? 6 : 1;
  float row[5];   // the rows (b0, b1, b2, a1, a2)
  float v1, v2;
  float* y;       // this lane's y in the chunk's stage of the y slot

  __device__ __forceinline__ void step(const float (&in)[kP], int t) {
    const float xt = snap(in[0]);
    const float c0 = pick<kPlanes>(in, 1, row[0]);
    const float c1 = pick<kPlanes>(in, 2, row[1]);
    const float c2 = pick<kPlanes>(in, 3, row[2]);
    const float d1 = pick<kPlanes>(in, 4, row[3]);
    const float d2 = pick<kPlanes>(in, 5, row[4]);
    const float out = c0 * xt + v1;
    const float nv1 = c1 * xt - d1 * out + v2;
    v2 = snap(c2 * xt - d2 * out);
    v1 = snap(nv1);
    y[t * kLanes] = out;
  }
};

// x [B, V]; b0, b1, b2, a1, a2 [V] (kPlanes false) or [B, V]; v1, v2 [V]
// -> y [B, V], v1', v2' [V].  Dynamic shared memory: the staged slots,
// then the y slot (ring_bytes(kP + 1)).
template <bool kPlanes>
__global__ void __launch_bounds__(oscen_stage::kBlock)
biquad_kernel(const float* __restrict__ x, const float* __restrict__ b0,
              const float* __restrict__ b1, const float* __restrict__ b2,
              const float* __restrict__ a1, const float* __restrict__ a2,
              const float* __restrict__ v1_in,
              const float* __restrict__ v2_in, float* __restrict__ y,
              float* __restrict__ v1_out, float* __restrict__ v2_out, int V,
              int B) {
  using Body = BiquadBody<kPlanes>;
  constexpr int kP = Body::kP;
  extern __shared__ __align__(16) float smem[];
  float* const y_slot = smem + kP * oscen_stage::kSlotFloats;
  const int l0 = blockIdx.x * kLanes;
  const int chunks = (B + kChunk - 1) / kChunk;
  if (threadIdx.x >= kLanes) {   // the producer warp
    const float* planes[6] = {x, b0, b1, b2, a1, a2};
    oscen_stage::Producer<kP> prod;
    prod.init(smem, planes, kP, V, B, l0);
    prod.run_staged(chunks, y_slot, y, 0);
    return;
  }
  const int v = l0 + threadIdx.x;
  const bool live = v < V;   // every thread syncs; live ones scan
  Body body{};
  if (live) {
    if constexpr (!kPlanes) {
      body.row[0] = b0[v];
      body.row[1] = b1[v];
      body.row[2] = b2[v];
      body.row[3] = a1[v];
      body.row[4] = a2[v];
    }
    body.v1 = v1_in[v];
    body.v2 = v2_in[v];
  }
  for (int c = 0; c < chunks; ++c) {
    oscen_stage::chunk_ready(c);
    if (live) {
      const float* src[kP];
      stage_ptrs<kP>(smem, c, src);
      body.y = y_slot + (c % kStages) * kChunk * kLanes + threadIdx.x;
      run_chunk<kP>(src, min(kChunk, B - c * kChunk), body);
    }
    // every chunk's stage is handed back: the producer writes y back
    oscen_stage::bar_arrive(oscen_stage::empty_id(c));
  }
  if (live) {
    v1_out[v] = body.v1;
    v2_out[v] = body.v2;
  }
}

template <bool kPlanes>
cudaError_t launch_biquad(const float* x, const float* b0, const float* b1,
                          const float* b2, const float* a1, const float* a2,
                          const float* v1, const float* v2, float* y,
                          float* v1_out, float* v2_out, int V, int B,
                          cudaStream_t stream) {
  // the staged planes and the y slot: 2 or 7 slots (84 KB)
  const int slots = BiquadBody<kPlanes>::kP + 1;
  const cudaError_t err = oscen_stage::allow_ring<biquad_kernel<kPlanes>>(
      slots);
  if (err != cudaSuccess) return err;
  biquad_kernel<kPlanes><<<(V + kLanes - 1) / kLanes, oscen_stage::kBlock,
                           oscen_stage::ring_bytes(slots), stream>>>(
      x, b0, b1, b2, a1, a2, v1, v2, y, v1_out, v2_out, V, B);
  return cudaGetLastError();
}

// K10.  What bounds it: the recurrence is serial in time, and the 4x saturator
// runs it on 2 lanes (one per branch) over 2048 and 1024 samples per block,
// so one warp on one SM does all the work: latency, not bytes (8 bytes per
// sample and lane).  Run in tick order, stage s waits for stage s - 1 at
// the same sample, so a step is S dependent stage updates of 3 float ops
// (6 at S = 2), while the cycle that really carries from step to step is
// one stage's own yp: 3 ops.  The design:
//  - stages skewed in time: iteration k runs stage s on sample k - s, from
//    the last stage down, so stage s reads the output stage s - 1 left in
//    its yp register one iteration earlier; the S updates of an iteration
//    are independent and the step's chain is one stage's 3 ops.  The
//    first S - 1 iterations fill the pipeline (scan_stage.cuh's run_chunk
//    with kFill = S - 1: stages s > k idle), the last S - 1 drain it after
//    the last chunk (stages whose samples are done idle); the steady loop
//    has no masks.  Each stage's carries hold its last real sample, and a
//    block shorter than the skew (B < S) fills straight into the drain.
//  - x through the staged ring (scan_stage.cuh: a producer warp's
//    cp.async, 4-byte copies at V = 2), read a group of 8 steps ahead.
//  - y lags S - 1 steps.  The chain warp stores it into a shared slot and
//    the producer writes each chunk back S - 1 rows earlier, as K6 writes
//    `before`: at V = 2 and at V = 256 both, the chain warp's own global
//    stores cost it more (28.1 against 38.9 cycles a step at V = 2, 36.6
//    against 41.1 at V = 256: PERF.md, PR 10).  The drain's S - 1 outputs
//    are stored directly.
template <int S>
struct AllpassBody {
  float c[S], xp[S], yp[S];
  float* y;      // this lane's outputs in the chunk's stage of the y slot

  // stage s on its input `cur`: the reference's three roundings
  __device__ __forceinline__ void stage(int s, float cur) {
    const float out = c[s] * (cur - yp[s]) + xp[s];
    xp[s] = cur;
    yp[s] = out;
  }

  // steady iteration k (chunk step t): stage s on sample k - s, the last
  // stage first, so each reads its predecessor's previous output
  __device__ __forceinline__ void step(const float (&in)[1], int t) {
#pragma unroll
    for (int s = S - 1; s > 0; --s) stage(s, yp[s - 1]);
    stage(0, in[0]);
    y[t * kLanes] = yp[S - 1];
  }

  // iteration k < S - 1 (k < B): stages s > k have no sample yet
  __device__ __forceinline__ void fill(const float (&in)[1], int k) {
#pragma unroll
    for (int s = S - 1; s > 0; --s)
      if (s <= k) stage(s, yp[s - 1]);
    stage(0, in[0]);
  }

  // iteration B + j (j < S - 1): stage s runs iff its sample B + j - s is
  // one of 0 .. B - 1; returns whether the last stage ran
  __device__ __forceinline__ bool drain(int j, int B) {
#pragma unroll
    for (int s = S - 1; s > 0; --s)
      if (s > j && s <= B + j) stage(s, yp[s - 1]);
    return S - 1 <= B + j;
  }
};

// x [B, V]; a, xp, yp [S, V] -> y [B, V], xp', yp' [S, V].  Dynamic shared
// memory: the x slot, then the y slot (ring_bytes(2)).
template <int S>
__global__ void __launch_bounds__(oscen_stage::kBlock)
allpass_kernel(const float* __restrict__ x, const float* __restrict__ a,
               const float* __restrict__ xp_in,
               const float* __restrict__ yp_in, float* __restrict__ y,
               float* __restrict__ xp_out, float* __restrict__ yp_out, int V,
               int B) {
  extern __shared__ __align__(16) float smem[];
  float* out_slot = smem + oscen_stage::kSlotFloats;
  const int l0 = blockIdx.x * kLanes;
  const int chunks = (B + kChunk - 1) / kChunk;
  if (threadIdx.x >= kLanes) {   // the producer warp
    const float* planes[1] = {x};
    oscen_stage::Producer<1> prod;
    prod.init(smem, planes, 1, V, B, l0);
    prod.run_staged(chunks, out_slot, y, S - 1);
    return;
  }
  const int v = l0 + threadIdx.x;
  const bool live = v < V;   // every thread syncs; live ones scan
  AllpassBody<S> body;
  if (live) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      body.c[s] = a[s * V + v];
      body.xp[s] = xp_in[s * V + v];
      body.yp[s] = yp_in[s * V + v];
    }
  }
  for (int c = 0; c < chunks; ++c) {
    oscen_stage::chunk_ready(c);
    if (live) {
      const float* src[1];
      oscen_stage::stage_ptrs<1>(smem, c, src);
      body.y = out_slot + (c % kStages) * kChunk * kLanes + threadIdx.x;
      oscen_stage::run_chunk<1, S - 1>(src, min(kChunk, B - c * kChunk),
                                       body, c == 0);
    }
    // every chunk's stage is handed back: the producer writes y back
    oscen_stage::bar_arrive(oscen_stage::empty_id(c));
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < S - 1; ++j)
      if (body.drain(j, B))
        y[(size_t)(B + j - (S - 1)) * V + v] = body.yp[S - 1];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      xp_out[s * V + v] = body.xp[s];
      yp_out[s * V + v] = body.yp[s];
    }
  }
}

// One launch of allpass_kernel<S> on `stream`, S from 1 to 8.
cudaError_t launch_allpass(int S, const float* x, const float* a,
                          const float* xp, const float* yp, float* y,
                          float* xp_out, float* yp_out, int V, int B,
                          cudaStream_t stream) {
  const dim3 grid((V + kLanes - 1) / kLanes);
  const size_t bytes = oscen_stage::ring_bytes(2);
  switch (S) {
#define OSCEN_ALLPASS_CASE(n)                                             \
  case n:                                                                 \
    allpass_kernel<n><<<grid, oscen_stage::kBlock, bytes, stream>>>(      \
        x, a, xp, yp, y, xp_out, yp_out, V, B);                           \
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
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Static and dynamic shared memory above 48 KB together need the kernel's
// opt-in (K8's table is 36 KB, the ring's slots 12 KB each): the most any
// launch here asks, 5 slots.
constexpr int kMaxSlots = 5;

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
  const dim3 grid((V + kLanes - 1) / kLanes);
  // x and each per-sample coefficient staged: at most 4 slots
  const int slots = 1 + (h_stride != 0) + (g_stride != 0) + (k_stride != 0);
  const size_t bytes = oscen_stage::ring_bytes(slots);
  const cudaStream_t st = (cudaStream_t)stream;
  const int form = (h_stride != 0) * 4 + (g_stride != 0) * 2 + (k_stride != 0);
  cudaError_t err = cudaSuccess;
  switch (form) {
#define OSCEN_TPT_CASE(n, a, b, c)                                           \
  case n:                                                                    \
    err = oscen_stage::allow_ring<tpt_svf_kernel<a, b, c>>(kMaxSlots);     \
    if (err != cudaSuccess) return (int)err;                                 \
    tpt_svf_kernel<a, b, c><<<grid, oscen_stage::kBlock, bytes, st>>>(                  \
        x, h, g, k, z0, z1, y, z0_out, z1_out, V, B);                        \
    break;
    OSCEN_TPT_CASE(0, false, false, false)
    OSCEN_TPT_CASE(1, false, false, true)
    OSCEN_TPT_CASE(2, false, true, false)
    OSCEN_TPT_CASE(3, false, true, true)
    OSCEN_TPT_CASE(4, true, false, false)
    OSCEN_TPT_CASE(5, true, false, true)
    OSCEN_TPT_CASE(6, true, true, false)
    OSCEN_TPT_CASE(7, true, true, true)
#undef OSCEN_TPT_CASE
  }
  return (int)cudaGetLastError();
}

// x [B, V]; g, h [V] (time stride 0) or [B, V] (time stride V); z [3, V]
// -> y [B, V], z' [3, V].
int oscen_lp18_scan(const float* x, const float* g, const float* h,
                    const float* z, float* y, float* z_out, int V, int B,
                    int g_stride, int h_stride, void* stream) {
  if (V < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((V + kLanes - 1) / kLanes);
  // x, per-sample g and h staged, and (per-sample g) the float64 plane of
  // its reciprocals
  const size_t bytes =
      oscen_stage::ring_bytes(1 + (g_stride != 0) + (h_stride != 0)) +
      (g_stride != 0 ? oscen_stage::ring_bytes(2) : 0);
  const cudaStream_t st = (cudaStream_t)stream;
  const int form = (g_stride != 0) * 2 + (h_stride != 0);
  cudaError_t err = cudaSuccess;
  switch (form) {
#define OSCEN_LP18_CASE(n, a, b)                                             \
  case n:                                                                    \
    err = oscen_stage::allow_ring<lp18_kernel<a, b>>(kMaxSlots);           \
    if (err != cudaSuccess) return (int)err;                                 \
    lp18_kernel<a, b><<<grid, oscen_stage::kBlock, bytes, st>>>(              \
        x, g, h, z, y, z_out, V, B);                                         \
    break;
    OSCEN_LP18_CASE(0, false, false)
    OSCEN_LP18_CASE(1, false, true)
    OSCEN_LP18_CASE(2, true, false)
    OSCEN_LP18_CASE(3, true, true)
#undef OSCEN_LP18_CASE
  }
  return (int)cudaGetLastError();
}

// K8's tanh over every float32 bit pattern: counts [3] (u64) += (its
// mismatches, its undecided inputs), counts[2] = min(., the first
// mismatching pattern).
int oscen_tanh_exact_sweep(unsigned long long* counts, void* stream) {
  tanh_exact_sweep<<<kSweepBlocks, kSweepThreads, 0, (cudaStream_t)stream>>>(
      counts);
  return (int)cudaGetLastError();
}

// y [n] = tanh_exact(b [n]); counts[1] += the undecided inputs.
int oscen_tanh_exact_map(const float* b, float* y, unsigned long long* counts,
                         int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  tanh_exact_map<<<(n + kSweepThreads - 1) / kSweepThreads, kSweepThreads, 0,
                   (cudaStream_t)stream>>>(
      b, y, n, counts);
  return (int)cudaGetLastError();
}

// every finite float32 a over the nd divisors ds [nd]: counts[0] += the
// pairs where K8's division differs from a / d.
int oscen_div_sweep(const float* ds, unsigned long long* counts, int nd,
                    void* stream) {
  if (nd < 1) return (int)cudaErrorInvalidValue;
  div_sweep<<<kSweepBlocks, kSweepThreads, 0, (cudaStream_t)stream>>>(
      ds, nd, counts);
  return (int)cudaGetLastError();
}

// x [B, V]; b0, b1, b2, a1, a2 all [V] (time stride 0) or all [B, V]
// (time stride V); v1, v2 [V] -> y [B, V], v1', v2' [V].  Mixed strides
// are refused (cudaErrorInvalidValue): the wrapper expands a mixed call's
// rows into planes.
int oscen_biquad_scan(const float* x, const float* b0, const float* b1,
                      const float* b2, const float* a1, const float* a2,
                      const float* v1, const float* v2, float* y,
                      float* v1_out, float* v2_out, int V, int B,
                      int b0_stride, int b1_stride, int b2_stride,
                      int a1_stride, int a2_stride, void* stream) {
  if (V < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const int planes = (b0_stride != 0) + (b1_stride != 0) +
                     (b2_stride != 0) + (a1_stride != 0) + (a2_stride != 0);
  const cudaStream_t st = (cudaStream_t)stream;
  if (planes == 0)
    return (int)launch_biquad<false>(x, b0, b1, b2, a1, a2, v1, v2, y,
                                     v1_out, v2_out, V, B, st);
  if (planes == 5)
    return (int)launch_biquad<true>(x, b0, b1, b2, a1, a2, v1, v2, y,
                                    v1_out, v2_out, V, B, st);
  return (int)cudaErrorInvalidValue;
}

// x [B, V]; a, xp, yp [S, V] (stage-major) -> y [B, V], xp', yp' [S, V];
// 1 <= S <= 8.  y is staged and written back by the producer.
int oscen_allpass_cascade_scan(const float* x, const float* a,
                               const float* xp, const float* yp, float* y,
                               float* xp_out, float* yp_out, int V, int B,
                               int S, void* stream) {
  if (V < 1 || B < 1) return (int)cudaErrorInvalidValue;
  return (int)launch_allpass(S, x, a, xp, yp, y, xp_out, yp_out, V, B,
                             (cudaStream_t)stream);
}

const char* oscen_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
