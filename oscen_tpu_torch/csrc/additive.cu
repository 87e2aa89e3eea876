// Fused electric-piano additive voice for Hopper (sm_90a).
//
// Replaces the TPU kernel oscen_tpu/ops/pallas/additive.py::
// _additive_voice_block in all its bodies: _kernel_v4 (closed-form
// subgroups, the default), _kernel_v3 (the same subgroups with the envelope
// rows from a per-tick recurrence), _kernel (v2: per-tick plane selects),
// _kernel_parity (exact per-sample op order), and _kernel_v4 with a stream
// epilogue (the Tremolo pan after the voice mix).  One steady block of
// AmplitudeSource -> OscillatorBank for every voice, optionally with the
// graph's FanIn voice mix-down fused in (with_mix).
//
// Layout: one warp per (voice, time segment), one lane per harmonic (H = 32
// = the warp width).  The complex oscillator, the envelope and the step
// counter stay in registers for the whole segment; no [B, V, H] product
// reaches device memory.  The per-voice row math of v4 / v3 / v2 (wrap
// tick, envelope product p, the row coefficients) is computed redundantly
// in every lane of the warp.
//
// What bounds it on the card: each voice is a serial chain per sample (the
// envelope recurrence and the complex rotation) plus a 32-lane harmonic sum,
// ~30 instructions a tick per warp; the kernel reads seven [H, V] planes
// once and writes [B, V] (or [B] with the mix), so it is bound by
// instruction latency, not by bytes or peak ops.  One warp per voice gave
// the flagship's 256 voices 256 warps, fewer than the card's 528 schedulers
// (132 SMs x 4), so each warp's latency was exposed.  The design answers
// with:
//  - time segments (the closed-form kernels v4, v3, v2 and the epilogue,
//    which share one template, so K3-K5 take them with K1): each voice's
//    block is split at subgroup boundaries into S segments, one warp each,
//    so V x S warps fill the schedulers.  segments() (additive_common.cuh,
//    the one place the choice is made; ops/cuda/additive.py and K16's
//    ablations in kabl.cu ask it) takes S = 4, halved
//    until S divides the B / SUB subgroups and each segment's ticket field
//    (32 / S bits of the mix's counters) holds its arrivals: S = 4 at the
//    piano's 256 voices for every B >= 4 SUB, S = 1 for B <= SUB, and
//    S = 4 up to ~8k voices.  SUB is the largest power of two up to 64
//    dividing B, so S > 1 needs SUB = 64.  (4 segments measured 19.0 µs
//    at V=256 B=1024 against 21.0 for 2 and 32.9 for 1: PERF.md.)  A
//    segment starting at subgroup K replays the state the sequential
//    kernel holds there (replay(), additive_common.cuh, which kabl.cu's
//    recur rows share) once per subgroup where the
//    step counter is on its integer cycle 0..64, and with the kernel's
//    own tick loop where it is not, so every segment computes the float
//    values the sequential kernel computes, for any input (an entry step
//    outside 0..64, inf or NaN too), and its outputs are those of one warp
//    per voice bit for bit.  A replay walks p tick by tick over at most
//    65 ticks (v3, v2: from the last wrap) or 64 + SUB (v4: from the last
//    subgroup that resets it), never the K x SUB ticks before the segment
//    unless the entry step never reaches the cycle.  The parity kernel
//    (K2) takes the same segments with its own N per harmonic sum
//    (segments() is asked with N for SUB: S = 4 at B = 1024 and 4096, N =
//    32), and its own replay (replay_parity(), below): the rotation has no
//    closed form in exact op order, so it is walked from tick 0 (2
//    dependent ops a tick, no harmonic sums or stores), but the envelope
//    is: the wrap tick (s = 64) sets cur = tgt and s = 0, and the next
//    tick's refresh cur * mult is then tgt * mult, so one 65-tick cycle
//    after the first wrap advances the envelope by one product;
//  - the harmonic sums as a warp reduce-scatter over N = min(32, SUB)
//    samples at once (additive_common.cuh): N - 1 + log2(32 / N) shuffles
//    per N samples instead of 5 per sample, lane L ends up holding the sum
//    of sample L, so each lane stores one value; its stages are template
//    instances, so the samples stay in registers (no local memory);
//  - the m^j tables (j = 1..SUB, 128 floats per lane at SUB = 64) replaced
//    by a running product per lane that restarts every subgroup; it is the
//    recurrence the tables were built with, so the values are the same and
//    no table occupies registers.  v3's and v2's per-tick rows are computed
//    inline in the same loop, in their order, instead of as a SUB-long
//    pre-pass array;
//  - the mix-down in a fixed order, inside the kernel (additive_common.cuh
//    finish_rows): each CUDA block (two voices, one segment) sums its warps
//    through shared memory into its voice block's partial row, for its
//    segment's ticks; the last block of each group of kMixGroup voice
//    blocks (a ticket per segment) sums its group's rows in block order,
//    and the segment's last group finisher sums the group rows in group
//    order and writes the mix, or, with the epilogue, the two tremolo
//    channels (the segment's blocks compute the pan factors of its ticks
//    first; they depend on the tick alone).  The tree over the voices of
//    every tick is the one-warp-per-voice kernel's, so the mix is too.  No
//    float atomics: the order, and so the result, is the same in every run,
//    and the fused and unfused pianos sum alike.
//
// Numerics: the library is built with --fmad=false, so every product and sum
// rounds as the separate elementwise ops of the plain PyTorch version do.
// The state planes then match that version bit for bit and only the harmonic
// and voice sums differ, in their order.  v3 and v4 compute the same float
// values in the same order (the JAX package pins them bit-identical), so
// their outputs are equal.  Denormals are kept (no -ftz), as in PyTorch; the
// TPU flushes them, a difference far below the tolerances.  The epilogue's
// sine is sin() in double rounded once to float, as ops/fmath.py computes it
// on the card.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include "additive_common.cuh"

namespace {

using oscen_additive::block_row;
using oscen_additive::kMaxSegments;
using oscen_additive::reduce_scatter;
using oscen_additive::replay;
using oscen_additive::segments;
using oscen_additive::tickets_fit;

constexpr int kMaxWarps = 32;
// Tremolo: the tick count at which the anchored phase rebases (K_REBASE)
constexpr float kRebase = 1048576.0f;
// 2*pi rounded to float, as PyTorch multiplies a float32 tensor by it
constexpr float kTau = (float)(2.0 * 3.14159265358979323846);

struct Planes {
  const float* osc_re;
  const float* osc_im;
  const float* mul_re;
  const float* mul_im;
  const float* cur;
  const float* tgt;
  const float* mult;
  const float* step;
  float* y;          // [B, V]; with the mix [B], or [B, 2] with the epilogue
  float* part;       // with the mix: [voice blocks + groups + 1, B] scratch
  unsigned* cnt;     // with the mix: [1 + groups] tickets, zero between calls
  const float* epi;  // the epilogue's [anchor, k0, dt, depth, a2], or null
  float* osc_re_out;
  float* osc_im_out;
  float* cur_out;
  float* tgt_out;
  float* step_out;
};

// Store the N per-sample sums of one chunk starting at sample t0.  Without
// the mix, y is [B, V]; with it, this block's partial row (its warps summed
// in warp order) goes to row[t0 ..].
template <int N>
__device__ __forceinline__ void store_chunk(float ysum, int t0, int lane,
                                            int warp, int v, int V,
                                            bool live, int with_mix,
                                            const Planes& P, float* row,
                                            float (*red)[33]) {
  if (!with_mix) {
    if (live && lane < N) P.y[(size_t)(t0 + lane) * V + v] = ysum;
    return;
  }
  if (lane < N) red[warp][lane] = ysum;
  block_row(red, N, row + t0);
}

// Tremolo's pan of tick t of the block (Tremolo._epilogue_fn): the
// anchored phase, its wrap, and the constant-power pan factor.
__device__ __forceinline__ float tremolo_pan(const float* epi, int t) {
  const float anchor = epi[0], k0 = epi[1], dt = epi[2], a2 = epi[4];
  const float d3 = epi[3] / 3.0f;  // IEEE quotient, as fmath.div
  const float ks = k0 + (float)t;
  float ph = ks < kRebase ? anchor + dt * ks : a2 + dt * (ks - kRebase);
  ph = ph - floorf(ph);
  const float lfo = (float)sin((double)(ph * kTau));
  return 0.5f + lfo * d3;
}

// Store the mix of the float4 column c: the 4 samples, or with the
// epilogue (epi not null) their two panned channels ([B, 2]).
__device__ __forceinline__ void store_mix(float* y, const float* epi,
                                          const float* pan, int c,
                                          float4 m) {
  if (epi == nullptr) {
    reinterpret_cast<float4*>(y)[c] = m;
    return;
  }
  const float4 pn = __ldcg(reinterpret_cast<const float4*>(pan) + c);
  float4* out = reinterpret_cast<float4*>(y) + 2 * c;  // samples 4c..4c+3
  out[0] = make_float4(m.x * pn.x, m.x * (1.f - pn.x),
                       m.y * pn.y, m.y * (1.f - pn.y));
  out[1] = make_float4(m.z * pn.z, m.z * (1.f - pn.z),
                       m.w * pn.w, m.w * (1.f - pn.w));
}

// The fixed-order mix of one segment (ticks [T0, T1)) over the nb voice
// blocks: every thread of every block calls this last, after its block's
// partial rows are stored.  With the epilogue (EPI, P.epi given), the
// segment's blocks first compute the pan factors of a share of its ticks
// (they depend on the tick alone), and its last finisher applies them to
// the mix.  A compile-time switch: the float64 sine's slow path for huge
// arguments (never taken here) keeps a local array, so only the epilogue's
// instances carry local memory.  Segment seg of segs counts its tickets in
// field seg of 32 / segs bits.
template <bool EPI>
__device__ __forceinline__ void finish_mix(const Planes& P, int B, int nb,
                                           int vb, int seg, int segs, int T0,
                                           int T1) {
  const int ng = (nb + oscen_additive::kMixGroup - 1) /
                 oscen_additive::kMixGroup;
  float* pan = P.part + (size_t)(nb + ng) * B;
  if constexpr (EPI)
    for (int t = T0 + vb * (int)blockDim.x + (int)threadIdx.x; t < T1;
         t += nb * (int)blockDim.x)
      pan[t] = tremolo_pan(P.epi, t);
  const int bits = 32 / segs;
  const unsigned unit = 1u << (bits * seg);
  const unsigned mask = bits == 32 ? 0xffffffffu : (1u << bits) - 1u;
  // the store captures plain pointers by value: a reference to the
  // kernel's parameters would put them in local memory
  float* y = P.y;
  const float* epi = EPI ? P.epi : nullptr;
  oscen_additive::finish_rows(P.part, P.cnt, nb, vb, B, T0 / 4, T1 / 4, unit,
                              mask, [=](int c, float4 m) {
                                store_mix(y, epi, pan, c, m);
                              });
}

// The closed-form kernels over subgroups of SUB ticks (at most one envelope
// cycle wrap per subgroup; the cycle is 65 ticks).  VER selects the row
// math: 4 = _kernel_v4 (the wrap tick jw in closed form), 3 = _kernel_v3
// (P recurrence and the wrapped flag carried tick by tick, the same amp
// expression as v4), 2 = _kernel (per-tick selects of (tgt, D) against the
// next cycle's (tgt2, D2), amp = tgtE + DE * P; the selects switch (tgt,
// D) in place at the wrap tick, which frees the registers its unrolled
// chunks need: 255, no spills on sm_90a).  EPI: v4 with the
// tremolo epilogue after the mix.  Block b runs voices (b % nb) * nw ..
// + nw - 1 over segment b / nb of `segs`.
template <int SUB, int VER, bool EPI>
__global__ void additive_closed_kernel(Planes P, int V, int B, int with_mix,
                                       int segs) {
  static_assert(!EPI || VER == 4, "the epilogue runs the v4 body");
  constexpr int N = SUB < 32 ? SUB : 32;
  __shared__ float red[kMaxWarps][33];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int nb = gridDim.x / segs;
  const int vb = blockIdx.x % nb;    // voice block: row vb of the mix
  const int seg = blockIdx.x / nb;
  const int v = vb * nw + warp;
  const bool live = v < V;
  const int at = lane * V + v;
  const int len = B / segs;           // a multiple of SUB
  const int T0 = seg * len, T1 = T0 + len;

  float zr = live ? P.osc_re[at] : 0.f;
  float zi = live ? P.osc_im[at] : 0.f;
  const float mr = live ? P.mul_re[at] : 0.f;
  const float mi = live ? P.mul_im[at] : 0.f;
  const float cur0 = live ? P.cur[at] : 0.f;
  const float tgt_in = live ? P.tgt[at] : 0.f;
  const float mult = live ? P.mult[at] : 0.f;
  float s = live ? P.step[v] : 0.f;

  // m^SUB by the recurrence that gives the per-tick powers m^(j+1)
  float msr = mr, msi = mi;
  for (int j = 1; j < SUB; ++j) {
    const float pr = msr, pi = msi;
    msr = pr * mr - pi * mi;
    msi = pr * mi + pi * mr;
  }

  // entry anchor: a wrap at the first tick takes its cycle base from cur
  float tgt = (s == 0.f) ? cur0 : tgt_in;
  float D = cur0 - tgt;
  float p = 1.f;
  float last_amp = cur0;
  const float C = 63.f / 64.f;
  if (T0 > 0) replay<SUB, VER>(T0 / SUB, msr, msi, mult, zr, zi, tgt, D, s,
                               p);
  float* row = with_mix ? P.part + (size_t)vb * B : nullptr;

  for (int t0 = T0; t0 < T1; t0 += SUB) {
    // next cycle's target, if a wrap occurs (v2 names it tgt2, D2 = -G1)
    const float tgtm = tgt * mult;
    const float G1 = tgtm - tgt;
    const float D2 = tgt - tgtm;
    const bool at0 = s == 0.f;
    const float jw = at0 ? 0.f : 65.f - s;  // v4: wrap tick (may be >= SUB)
    const float basef = s * (-1.f / 64.f);
    const float addf = at0 ? 0.f : 65.f / 64.f;
    bool wrapped = false;  // v3: a wrap seen in this subgroup so far
    float wr = mr, wi = mi;  // m^(j+1)
    // the subgroup's chunks unrolled: one chunk's harmonic sum overlaps
    // the next chunk's ticks
#pragma unroll
    for (int c = 0; c < SUB / N; ++c) {
      float vals[N];
#pragma unroll
      for (int jj = 0; jj < N; ++jj) {
        float amp;
        if constexpr (VER == 4) {
          const int j = c * N + jj;
          const bool wfb = jw <= (float)j;
          const float cjb = basef + (63.f - (float)j) * (1.f / 64.f);
          const float f = cjb + (wfb ? addf : 0.f);
          p = (jw == (float)j) ? C : p * f;
          const float r1 = wfb ? 0.f : p;
          const float r2 = wfb ? 1.f - p : 0.f;
          amp = r2 * G1 + (r1 * D + tgt);
        } else {
          const bool wrap = s == 0.f;
          wrapped = wrapped || wrap;
          p = wrap ? C : p * (1.f - (s + 1.f) / 64.f);
          s = s < 64.f ? s + 1.f : 0.f;
          if constexpr (VER == 3) {
            const float r1 = wrapped ? 0.f : p;
            const float r2 = wrapped ? 1.f - p : 0.f;
            amp = r2 * G1 + (r1 * D + tgt);
          } else {
            // two wraps are 65 ticks apart, so a subgroup holds at most
            // one: (tgt, D) switch to the next cycle's in place, with the
            // values of v2's per-tick selects and no wrapped flag
            tgt = wrap ? tgtm : tgt;
            D = wrap ? D2 : D;
            amp = tgt + D * p;
          }
        }
        const float im = zr * (wi * 3.f) + zi * (wr * 3.f);
        vals[jj] = im * amp;
        last_amp = amp;
        const float pr = wr, pi = wi;
        wr = pr * mr - pi * mi;
        wi = pr * mi + pi * mr;
      }
      const float ysum = reduce_scatter<N>(vals, lane);
      store_chunk<N>(ysum, t0 + c * N, lane, warp, v, V, live, with_mix, P,
                     row, red);
    }
    const float nzr = zr * msr - zi * msi;
    const float nzi = zr * msi + zi * msr;
    zr = nzr;
    zi = nzi;
    if constexpr (VER == 4) {
      const bool w_last = jw <= (float)(SUB - 1);
      tgt = w_last ? tgtm : tgt;
      D = w_last ? -G1 : D;
      // the step counter cycles 0..64 and SUB <= 64: one subtract is a mod
      const float t = s + (float)SUB;
      s = t >= 65.f ? t - 65.f : t;
    } else if constexpr (VER == 3) {
      tgt = wrapped ? tgtm : tgt;
      D = wrapped ? -G1 : D;
    }
  }

  if (live && seg == segs - 1) {
    P.osc_re_out[at] = zr;
    P.osc_im_out[at] = zi;
    P.cur_out[at] = last_amp;
    P.tgt_out[at] = tgt;
    if (lane == 0) P.step_out[v] = s;
  }
  if (with_mix) finish_mix<EPI>(P, B, nb, vb, seg, segs, T0, T1);
}

// _kernel_parity's envelope tick: the target refresh at step 0, the
// linear blend, the step advance, in the reference's op order.
__device__ __forceinline__ void parity_tick(float& cur, float& tgt, float& s,
                                            float mult) {
  tgt = (s == 0.f) ? cur * mult : tgt;
  const bool interp = s < 64.f;
  const float tau = (s + 1.f) / 64.f;
  const float cur_i = cur * (1.f - tau) + tgt * tau;
  cur = interp ? cur_i : tgt;
  s = interp ? s + 1.f : 0.f;
}

// One tick of the complex rotation z <- z m.
__device__ __forceinline__ void rotate(float& zr, float& zi, float mr,
                                       float mi) {
  const float nre = zr * mr - zi * mi;
  const float nim = zr * mi + zi * mr;
  zr = nre;
  zi = nim;
}

// The step counter on its integer cycle 0..64 (-0.0 counts as 0).
__device__ __forceinline__ bool on_cycle(float s) {
  return s == floorf(s) && s >= 0.f && s <= 64.f;
}

// The state the parity kernel holds at tick T, from the block-start state
// (zr, zi, cur, tgt, s), with the body's own ops:
//  (a) while the step is off its integer cycle 0..64 (an entry step the
//      envelope never produces: -2.5, 70, inf, NaN), the body's ticks,
//      envelope and rotation, one at a time: a step on the cycle stays on
//      it.  While s + 8 < 0, 8 ticks at a time, as the blend and s + 1
//      alone: the 8 ticks' steps are all below 0, so none refreshes tgt or
//      stops the blend, and these are the same float ops with the selects
//      left out.  A stuck counter (s + 1 == s, e.g. -2^25, -inf) stays
//      there and walks all T that way;
//  (b) on the cycle from tick t with step s: the wrap tick (s = 64) is
//      tick t + 64 - s.  If it comes before T, the stretch up to it leaves
//      cur = tgt and s = 0, with tgt refreshed from the block's own cur
//      (cur * mult) if the stretch starts at step 0.  Each 65 ticks after
//      it then refresh tgt = cur * mult = tgt * mult and end at the next
//      wrap tick with cur = tgt again: one product a cycle.  The ticks
//      after the last wrap before T (at most 64, no wrap among them), or
//      from t if no wrap comes before T, are walked with the body's tick;
//  (c) the rotation alone (it never reads the envelope) up to the tick
//      that walk starts from, then both together: two independent chains,
//      so the envelope's ticks hide under the rotation's.
__device__ __forceinline__ void replay_parity(int T, float mr, float mi,
                                              float mult, float& zr,
                                              float& zi, float& cur,
                                              float& tgt, float& s) {
  int t = 0;
#pragma unroll 1
  for (; t + 8 <= T && s + 8.f < 0.f; t += 8) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float tau = (s + 1.f) / 64.f;
      cur = cur * (1.f - tau) + tgt * tau;
      s = s + 1.f;
      rotate(zr, zi, mr, mi);
    }
  }
#pragma unroll 1
  for (; t < T && !on_cycle(s); ++t) {
    parity_tick(cur, tgt, s, mult);
    rotate(zr, zi, mr, mi);
  }
  int tw = T;   // the tick the envelope is walked from
  if (t < T) {
    const int wrap = t + 64 - (int)s;   // the first wrap tick on the cycle
    tw = t;
    if (wrap < T) {
      if (s == 0.f) tgt = cur * mult;
      const int n = (T - wrap - 1) / 65;
#pragma unroll 1
      for (int k = 0; k < n; ++k) tgt = tgt * mult;
      cur = tgt;
      s = 0.f;
      tw = wrap + 1 + 65 * n;
    }
  }
#pragma unroll 8
  for (int i = t; i < tw; ++i) rotate(zr, zi, mr, mi);
#pragma unroll 4
  for (int i = tw; i < T; ++i) {
    parity_tick(cur, tgt, s, mult);
    rotate(zr, zi, mr, mi);
  }
}

// _kernel_parity: per sample, the envelope tick and then the rotation, in
// the reference's op order.  N samples are summed per reduce-scatter.
// Block b runs voices (b % nb) * nw .. + nw - 1 over segment b / nb of
// `segs`; a segment starting at tick T0 > 0 replays the state there.
template <int N>
__global__ void additive_parity_kernel(Planes P, int V, int B, int with_mix,
                                       int segs) {
  __shared__ float red[kMaxWarps][33];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int nb = gridDim.x / segs;
  const int vb = blockIdx.x % nb;    // voice block: row vb of the mix
  const int seg = blockIdx.x / nb;
  const int v = vb * nw + warp;
  const bool live = v < V;
  const int at = lane * V + v;
  const int len = B / segs;           // a multiple of N
  const int T0 = seg * len, T1 = T0 + len;

  float zr = live ? P.osc_re[at] : 0.f;
  float zi = live ? P.osc_im[at] : 0.f;
  const float mr = live ? P.mul_re[at] : 0.f;
  const float mi = live ? P.mul_im[at] : 0.f;
  float cur = live ? P.cur[at] : 0.f;
  float tgt = live ? P.tgt[at] : 0.f;
  const float mult = live ? P.mult[at] : 0.f;
  float s = live ? P.step[v] : 0.f;
  if (T0 > 0) replay_parity(T0, mr, mi, mult, zr, zi, cur, tgt, s);
  float* row = with_mix ? P.part + (size_t)vb * B : nullptr;

  for (int t0 = T0; t0 < T1; t0 += N) {
    float vals[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      parity_tick(cur, tgt, s, mult);
      rotate(zr, zi, mr, mi);
      vals[k] = zi * cur;
    }
    const float ysum = reduce_scatter<N>(vals, lane) * 3.f;
    store_chunk<N>(ysum, t0, lane, warp, v, V, live, with_mix, P, row, red);
  }

  if (live && seg == segs - 1) {
    P.osc_re_out[at] = zr;
    P.osc_im_out[at] = zi;
    P.cur_out[at] = cur;
    P.tgt_out[at] = tgt;
    if (lane == 0) P.step_out[v] = s;
  }
  if (with_mix) finish_mix<false>(P, B, nb, vb, seg, segs, T0, T1);
}

Planes make_planes(const float* osc_re, const float* osc_im,
                   const float* mul_re, const float* mul_im, const float* cur,
                   const float* tgt, const float* mult, const float* step,
                   float* y, float* part, unsigned* cnt, const float* epi,
                   float* osc_re_out, float* osc_im_out, float* cur_out,
                   float* tgt_out, float* step_out) {
  return Planes{osc_re, osc_im,     mul_re,     mul_im,  cur,     tgt,
                mult,   step,       y,          part,    cnt,     epi,
                osc_re_out, osc_im_out, cur_out, tgt_out, step_out};
}

// Whether segs segments per voice can run: a power of two up to
// kMaxSegments dividing the B / sub subgroups (parity: harmonic-sum
// chunks), and with the mix, tickets that fit their fields.
bool segments_ok(int V, int B, int sub, int with_mix, int warps_per_block,
                 int segs) {
  return segs >= 1 && segs <= kMaxSegments && !(segs & (segs - 1)) &&
         (B / sub) % segs == 0 &&
         (!with_mix || tickets_fit(segs, V, warps_per_block));
}

template <int VER, bool EPI = false>
int launch_closed(const Planes& P, int V, int B, int sub, int with_mix,
                  int warps_per_block, int segs, void* stream) {
  if (!segments_ok(V, B, sub, with_mix, warps_per_block, segs))
    return (int)cudaErrorInvalidValue;
  const dim3 block(32 * warps_per_block);
  const dim3 grid(((V + warps_per_block - 1) / warps_per_block) * segs);
  cudaStream_t st = (cudaStream_t)stream;
  switch (sub) {
#define OSCEN_CLOSED_CASE(n)                                              \
  case n:                                                                 \
    additive_closed_kernel<n, VER, EPI><<<grid, block, 0, st>>>(           \
        P, V, B, with_mix, segs);                                         \
    break;
    OSCEN_CLOSED_CASE(8)
    OSCEN_CLOSED_CASE(16)
    OSCEN_CLOSED_CASE(32)
    OSCEN_CLOSED_CASE(64)
#undef OSCEN_CLOSED_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int launch_parity(const Planes& P, int V, int B, int sub, int with_mix,
                  int warps_per_block, int segs, void* stream) {
  if (!segments_ok(V, B, sub, with_mix, warps_per_block, segs))
    return (int)cudaErrorInvalidValue;
  const dim3 block(32 * warps_per_block);
  const dim3 grid(((V + warps_per_block - 1) / warps_per_block) * segs);
  cudaStream_t st = (cudaStream_t)stream;
  switch (sub) {
#define OSCEN_PARITY_CASE(n)                                                \
  case n:                                                                   \
    additive_parity_kernel<n><<<grid, block, 0, st>>>(P, V, B, with_mix,    \
                                                      segs);                \
    break;
    OSCEN_PARITY_CASE(8)
    OSCEN_PARITY_CASE(16)
    OSCEN_PARITY_CASE(32)
#undef OSCEN_PARITY_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One steady block.  Planes are [32, V] row-major, step and step_out [V].
// Without the mix y is [B, V] and part, cnt and epi are null.  With it, y is
// the [B] mix, or with epi (the Tremolo parameters [anchor, k0, dt, depth,
// a2]) the [B, 2] panned channels; part is [ceil(V / warps_per_block) +
// groups + 1, B] scratch (the voice blocks' rows, the group rows, the pan
// factors) and cnt [1 + groups] zeroed counters (groups = ceil(voice blocks
// / 16)), which the launch leaves zeroed.  sub is the subgroup length (8,
// 16, 32 or 64; divides B).  The closed-form versions split each voice
// into oscen_additive_segments(V, B, sub, warps_per_block) time segments.
// The epilogue runs in the v4 body only.
#define OSCEN_ADDITIVE_ARGS_NO_STREAM                                        \
  const float *osc_re, const float *osc_im, const float *mul_re,             \
      const float *mul_im, const float *cur, const float *tgt,               \
      const float *mult, const float *step, float *y, float *part,           \
      unsigned *cnt, const float *epi, float *osc_re_out, float *osc_im_out, \
      float *cur_out, float *tgt_out, float *step_out, int V, int B,         \
      int sub, int with_mix, int warps_per_block
#define OSCEN_ADDITIVE_ARGS OSCEN_ADDITIVE_ARGS_NO_STREAM, void *stream
#define OSCEN_ADDITIVE_PLANES                                             \
  make_planes(osc_re, osc_im, mul_re, mul_im, cur, tgt, mult, step, y,    \
              part, cnt, epi, osc_re_out, osc_im_out, cur_out, tgt_out,   \
              step_out)

// The time segments per voice the closed-form versions run.
int oscen_additive_segments(int V, int B, int sub, int warps_per_block) {
  return segments(V, B, sub, warps_per_block);
}

int oscen_additive_v4(OSCEN_ADDITIVE_ARGS) {
  if (warps_per_block < 1 || warps_per_block > kMaxWarps || B % 4 ||
      (epi && !with_mix))
    return (int)cudaErrorInvalidValue;
  const int segs = segments(V, B, sub, warps_per_block);
  if (epi)
    return launch_closed<4, true>(OSCEN_ADDITIVE_PLANES, V, B, sub, with_mix,
                                  warps_per_block, segs, stream);
  return launch_closed<4>(OSCEN_ADDITIVE_PLANES, V, B, sub, with_mix,
                          warps_per_block, segs, stream);
}

int oscen_additive_v3(OSCEN_ADDITIVE_ARGS) {
  if (warps_per_block < 1 || warps_per_block > kMaxWarps || B % 4 || epi)
    return (int)cudaErrorInvalidValue;
  return launch_closed<3>(OSCEN_ADDITIVE_PLANES, V, B, sub, with_mix,
                          warps_per_block,
                          segments(V, B, sub, warps_per_block), stream);
}

int oscen_additive_v2(OSCEN_ADDITIVE_ARGS) {
  if (warps_per_block < 1 || warps_per_block > kMaxWarps || B % 4 || epi)
    return (int)cudaErrorInvalidValue;
  return launch_closed<2>(OSCEN_ADDITIVE_PLANES, V, B, sub, with_mix,
                          warps_per_block,
                          segments(V, B, sub, warps_per_block), stream);
}

// The closed-form body `ver` (4, 3 or 2), or the exact-op-order body (ver
// 0, sub as for oscen_additive_parity), with `segs` segments per voice (1,
// 2 or 4, dividing B / sub; with the mix, only where the tickets fit)
// instead of segments()' choice, arguments as above: S = 1 is one warp per
// voice over the whole block.  For tools/scanprobe.py, which prices the
// segment count, and the card tests.
int oscen_additive_closed_segs(OSCEN_ADDITIVE_ARGS_NO_STREAM, int ver,
                               int segs, void* stream) {
  if (warps_per_block < 1 || warps_per_block > kMaxWarps || B % 4 || epi)
    return (int)cudaErrorInvalidValue;
  const Planes P = OSCEN_ADDITIVE_PLANES;
  switch (ver) {
    case 4:
      return launch_closed<4>(P, V, B, sub, with_mix, warps_per_block, segs,
                              stream);
    case 3:
      return launch_closed<3>(P, V, B, sub, with_mix, warps_per_block, segs,
                              stream);
    case 2:
      return launch_closed<2>(P, V, B, sub, with_mix, warps_per_block, segs,
                              stream);
    case 0:
      return launch_parity(P, V, B, sub, with_mix, warps_per_block, segs,
                           stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The exact-op-order kernel; sub (8, 16 or 32, divides B) is the number of
// samples per harmonic reduce-scatter.  Layout as above, with
// oscen_additive_segments(V, B, sub, warps_per_block) time segments per
// voice; no epilogue.
int oscen_additive_parity(OSCEN_ADDITIVE_ARGS) {
  if (warps_per_block < 1 || warps_per_block > kMaxWarps || B % 4 || epi)
    return (int)cudaErrorInvalidValue;
  return launch_parity(OSCEN_ADDITIVE_PLANES, V, B, sub, with_mix,
                       warps_per_block, segments(V, B, sub, warps_per_block),
                       stream);
}

const char* oscen_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
