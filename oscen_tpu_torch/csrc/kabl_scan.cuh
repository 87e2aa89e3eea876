// The segmented cumprod rows of K16's scan bodies (kabl.cu's scan rows,
// kabl6 v5 rows_for; kabl_hmaj.cu's rows, kabl5 rows_for): one subgroup's
// envelope rows at once, lane j = tick j (and j + 32 at SUB = 64), and the
// replay of their carry p for a time segment that starts at subgroup K.
//
// Per subgroup from the step s (the same in every lane of the warp): tick
// j wraps (wr) iff S = s + j >= 65 or s == 0; its factor a = (63 - se) / 64
// with se = S less the cycle (65, or 0 when s == 0) where it wraps; am / ap
// are the post- and pre-wrap factors, scanned into cumulative products in
// the Hillis-Steele order of the tools (x[J] * x[J - sh] for J >= sh, sh =
// 1, 2, 4, ...: the TPU's pltpu.roll).  r1 = p * ap before the wrap, r2 =
// 1 - am after it; the carry p' = am of the last tick where it wraps, else
// p * ap of the last tick; the step after the subgroup s' = se + 1 of the
// last tick, or 0 past 64.
//
// So a subgroup whose last tick wraps sets p' whatever p was: the carry at
// subgroup K depends only on the subgroups from the last such one before
// K.  scan_replay_p walks the steps (scan_step, two compares and a few
// adds a subgroup) to find it, then scans from there: for an entry step on
// the cycle 0..64 one subgroup of every two or three resets (a wrap every
// 65 ticks), so the replay scans at most three subgroups; for any other
// entry step (a fraction, a negative, NaN, inf) it scans from the first
// reset, or from tick 0, with the body's own ops.

#pragma once

#include <cuda_runtime.h>

#include "additive_common.cuh"

namespace oscen_kscan {

using oscen_additive::kFull;

// The log-step multiplicative scan of lo (lane j's tick) and, at SUB = 64,
// hi (tick j + 32), in the tools' order.
template <int SUB>
__device__ __forceinline__ void scan_mul(float& lo, float& hi, int lane) {
#pragma unroll
  for (int sh = 1; sh < 32; sh *= 2) {
    const int src = (lane - sh) & 31;
    const float xlo = __shfl_sync(kFull, lo, src);
    if constexpr (SUB == 64) {
      const float xhi = __shfl_sync(kFull, hi, src);
      hi = hi * (lane >= sh ? xhi : xlo);
    }
    if (lane >= sh) lo = lo * xlo;
  }
  if constexpr (SUB == 64) hi = hi * lo;  // sh = 32
}

// The step's move over one subgroup (the last tick's values, which the
// tools read from the scan's last row): returns whether the last tick
// wraps (the cycle's (tgt, D) move on, and p' = am), and steps s to s'.
template <int SUB>
__device__ __forceinline__ bool scan_step(float& s) {
  const bool s0z = s == 0.f;
  const float S = s + (float)(SUB - 1);
  const bool wr = S >= 65.f || s0z;
  const float shift = s0z ? 0.f : 65.f;
  const float se = wr ? S - shift : S;
  s = se < 64.f ? se + 1.f : 0.f;
  return wr;
}

// One subgroup's rows from step s and carry p: r1[h], r2[h] of tick lane
// + 32 h (h = 1 only at SUB = 64); returns the carry p' (lane 31's, in
// every lane).
template <int SUB>
__device__ __forceinline__ float scan_rows(float s, float p, int lane,
                                           float (&r1)[2], float (&r2)[2]) {
  const bool s0z = s == 0.f;
  float am[2], ap[2];
  bool wr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h == 1 && SUB == 32) {
      am[1] = ap[1] = 0.f;
      wr[1] = false;
      continue;
    }
    const float S = s + (float)(lane + 32 * h);
    wr[h] = S >= 65.f || s0z;
    const float shift = s0z ? 0.f : 65.f;
    const float se = wr[h] ? S - shift : S;
    const float a = (63.f - se) * (1.f / 64.f);
    am[h] = wr[h] ? a : 1.f;
    ap[h] = wr[h] ? 1.f : a;
  }
  scan_mul<SUB>(am[0], am[1], lane);
  scan_mul<SUB>(ap[0], ap[1], lane);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    r1[h] = p * (wr[h] ? 0.f : ap[h]);
    r2[h] = wr[h] ? 1.f - am[h] : 0.f;
  }
  constexpr int L = SUB / 32 - 1;  // the last tick is lane 31's
  const float p_last = wr[L] ? am[L] : p * ap[L];
  return __shfl_sync(kFull, p_last, 31);
}

// The carry p at the start of subgroup K from the block-start step s0 and
// p = 1 (the source note): every lane of the warp calls it with the same
// s0 and gets the same p.
template <int SUB>
__device__ __forceinline__ float scan_replay_p(int K, float s0, int lane) {
  int kr = -1;      // the last subgroup before K whose last tick wraps
  float sr = 0.f;   // its entry step
  float s = s0;
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    const float sk = s;
    if (scan_step<SUB>(s)) {
      kr = k;
      sr = sk;
    }
  }
  float p = 1.f;
  s = kr >= 0 ? sr : s0;
  float r1[2], r2[2];
#pragma unroll 1
  for (int k = kr >= 0 ? kr : 0; k < K; ++k) {
    p = scan_rows<SUB>(s, p, lane, r1, r2);
    scan_step<SUB>(s);
  }
  return p;
}

}  // namespace oscen_kscan
