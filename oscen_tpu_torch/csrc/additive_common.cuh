// Helpers shared by the additive-voice kernels (additive.cu, K1-K5) and
// their ablations (kabl.cu, kabl_hmaj.cu; K16): the harmonic sum as a warp
// reduce-scatter, the block's partial row of the voice mix, and the
// fixed-order mix over the blocks' rows.
//
// The mix: every CUDA block stores one partial row per tick range (its
// warps summed in warp order, block_row); the last block of each group of
// kMixGroup blocks, found by a ticket from a device counter, sums its
// group's rows in block order into a group row; the last group finisher
// sums the group rows in group order and hands each float4 column to the
// caller's store (finish_rows).  No float atomics: the order, and so the
// result, is the same in every run.
//
// A launch may run several tick ranges (segments) of the same rows at
// once: each segment counts in its own field of the counter words, and
// its finishers sum only its columns.  segments() picks how many, and
// replay() rebuilds the state of a closed-form voice (v4, v3, v2) at a
// segment's first subgroup; additive.cu and kabl.cu both ask them.

#pragma once

#include <cuda_runtime.h>

namespace oscen_additive {

constexpr unsigned kFull = 0xffffffffu;
// blocks per first-level group of the fixed-order mix
constexpr int kMixGroup = 16;

// One stage of the reduce-scatter: the lanes whose bit HALF is set keep
// the upper half of the samples and receive it from their partner.
template <int HALF, int N>
__device__ __forceinline__ void rs_stages(float (&vals)[N], int lane) {
  if constexpr (HALF >= 1) {
    const bool upper = (lane & HALF) != 0;
#pragma unroll
    for (int k = 0; k < HALF; ++k) {
      const float send = upper ? vals[k] : vals[k + HALF];
      const float keep = upper ? vals[k + HALF] : vals[k];
      vals[k] = keep + __shfl_xor_sync(kFull, send, HALF);
    }
    rs_stages<HALF / 2>(vals, lane);
  }
}

// The butterfly over the lane bits O, 2 O, .. 16 that the N samples did
// not split (N < 32).
template <int O>
__device__ __forceinline__ float rs_tail(float s) {
  if constexpr (O < 32) {
    s += __shfl_xor_sync(kFull, s, O);
    return rs_tail<2 * O>(s);
  } else {
    return s;
  }
}

// Sum vals[0..N) over the 32 lanes (N a power of two, at most 32).
// Afterwards lane L holds the sum of sample L % N: N - 1 + log2(32 / N)
// shuffles.  Stage c -> c/2 keeps the upper half of the samples in the
// lanes whose bit c/2 is set.  The stages are template instances, so every
// index into vals is a constant and vals stays in registers (a loop over
// the stages, even with #pragma unroll, is left rolled by nvcc and puts
// vals in local memory).
template <int N>
__device__ __forceinline__ float reduce_scatter(float (&vals)[N], int lane) {
  static_assert(N >= 1 && N <= 32 && (N & (N - 1)) == 0,
                "N is a power of two up to the warp width");
  rs_stages<N / 2>(vals, lane);
  return rs_tail<N>(vals[0]);
}

// The block's partial row of n ticks: red[w][i] (each warp's sum of tick
// i) summed over the block's warps in warp order into row[i].  Every
// thread of the block calls it after storing its warp's red row.
__device__ __forceinline__ void block_row(float (*red)[33], int n,
                                          float* row) {
  __syncthreads();
  if ((int)threadIdx.x < n) {
    float acc = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w)
      acc += red[w][threadIdx.x];
    row[threadIdx.x] = acc;
  }
  __syncthreads();
}

// Sum n rows of B floats (row stride B) in row order, 4 ticks per load,
// for the float4 columns c0 and c1 (c1 < 0: none).  The rows were written
// by other blocks: read them from L2 (__ldcg).  Up to kMixGroup rows of
// both columns are loaded before any is added, so one thread keeps 32
// loads in flight; the adds keep the row order.
__device__ __forceinline__ void sum_rows2(const float* rows, int n, int B,
                                          int c0, int c1, float4& a0,
                                          float4& a1) {
  const float4* r = reinterpret_cast<const float4*>(rows);
  const size_t stride = B / 4;
  a0 = make_float4(0.f, 0.f, 0.f, 0.f);
  a1 = a0;
  for (int i0 = 0; i0 < n; i0 += kMixGroup) {
    float4 x0[kMixGroup], x1[kMixGroup];
#pragma unroll
    for (int i = 0; i < kMixGroup; ++i) {
      if (i0 + i < n) {
        x0[i] = __ldcg(r + (i0 + i) * stride + c0);
        if (c1 >= 0) x1[i] = __ldcg(r + (i0 + i) * stride + c1);
      }
    }
#pragma unroll
    for (int i = 0; i < kMixGroup; ++i) {
      if (i0 + i < n) {
        a0.x += x0[i].x;
        a0.y += x0[i].y;
        a0.z += x0[i].z;
        a0.w += x0[i].w;
        if (c1 >= 0) {
          a1.x += x1[i].x;
          a1.y += x1[i].y;
          a1.z += x1[i].z;
          a1.w += x1[i].w;
        }
      }
    }
  }
}

// A ticket: add this arrival to its field of *word (the field's unit,
// e.g. 1 << 8 for the second 8-bit field, and its mask after the shift);
// true for the last of n arrivals.
__device__ __forceinline__ bool last_arrival(unsigned* word, unsigned unit,
                                             unsigned mask, int n) {
  const unsigned old = atomicAdd(word, unit);
  return ((old / unit) & mask) == (unsigned)(n - 1);
}

// The fixed-order mix: every thread of every block calls this last, after
// its block's partial rows are stored.  part holds the nb block rows, then
// the ceil(nb / kMixGroup) group rows, each of B floats; cnt the group
// tickets [1 + groups] (cnt[0] for the groups), zero between launches and
// left so.  This block is row b of the mix, for the float4 columns
// [c_lo, c_hi) of one segment, which counts in the counter field (unit,
// mask).  The last group finisher calls store(c, sum) for each column of
// the segment (a functor taken by value: give it pointers, not references,
// or they land in local memory).
template <class Store>
__device__ __forceinline__ void finish_rows(float* part, unsigned* cnt,
                                            int nb, int b, int B, int c_lo,
                                            int c_hi, unsigned unit,
                                            unsigned mask, Store store) {
  __shared__ int s_last;
  const int ng = (nb + kMixGroup - 1) / kMixGroup;
  const int g = b / kMixGroup;
  const int n = min(kMixGroup, nb - g * kMixGroup);
  // publish this block's rows, then take a ticket of its group
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = last_arrival(&cnt[1 + g], unit, mask, n);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the group's last block: its rows in block order -> group row
  const int step = 2 * (int)blockDim.x;
  float4* grow = reinterpret_cast<float4*>(part + (size_t)(nb + g) * B);
  for (int c = c_lo + threadIdx.x; c < c_hi; c += step) {
    const int c1 = c + (int)blockDim.x < c_hi ? c + (int)blockDim.x : -1;
    float4 a0, a1;
    sum_rows2(part + (size_t)g * kMixGroup * B, n, B, c, c1, a0, a1);
    grow[c] = a0;
    if (c1 >= 0) grow[c1] = a1;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    // this field ready for the next launch on this stream
    atomicAdd(&cnt[1 + g], 0u - (unsigned)n * unit);
    s_last = last_arrival(&cnt[0], unit, mask, ng);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last group finisher: the group rows in group order -> the mix
  const float* rows = part + (size_t)nb * B;
  for (int c = c_lo + threadIdx.x; c < c_hi; c += step) {
    const int c1 = c + (int)blockDim.x < c_hi ? c + (int)blockDim.x : -1;
    float4 a0, a1;
    sum_rows2(rows, ng, B, c, c1, a0, a1);
    store(c, a0);
    if (c1 >= 0) store(c1, a1);
  }
  if (threadIdx.x == 0) atomicAdd(&cnt[0], 0u - (unsigned)ng * unit);
}

// time segments per voice: at most 4 (a ticket field of 8 bits or more)
constexpr int kMaxSegments = 4;

// Whether segs segments' tickets fit their counter fields: segment seg
// counts in field seg of 32 / segs bits, which must hold the arrivals of a
// group (up to kMixGroup voice blocks) and of the groups.
inline bool tickets_fit(int segs, int V, int warps_per_block) {
  if (segs == 1) return true;
  const long long mask = (1ll << (32 / segs)) - 1;
  const int nb = (V + warps_per_block - 1) / warps_per_block;
  const int ng = (nb + kMixGroup - 1) / kMixGroup;
  return ng <= mask && kMixGroup <= mask;
}

// Segments per voice for V voices, B ticks and subgroups of sub ticks
// (additive.cu's source note): kMaxSegments, halved until they divide the
// B / sub subgroups and their tickets fit.
inline int segments(int V, int B, int sub, int warps_per_block) {
  int s = kMaxSegments;
  while (s > 1 && ((B / sub) % s || !tickets_fit(s, V, warps_per_block)))
    s /= 2;
  return s;
}

// The state the sequential kernel holds at the start of subgroup K, from
// the block-start state (zr, zi, tgt, D, s, p = 1), with the kernel's ops
// in its order: K subgroup steps of the oscillator (x m^SUB) and of the
// cycle's (tgt, D).
//  - v3 and v2 carry s and p tick by tick.  Their replay walks whole
//    subgroups with their own tick loop (without the harmonic sums) only
//    while a subgroup starts off the step's cycle, i.e. with s not an
//    integer in 0..64 (an entry step the envelope never produces: -2.5,
//    1e-10, 70, inf, NaN; s >= 64, inf and NaN reach 0 after one tick, a
//    stuck counter such as -1e9, where s + 1 == s, walks all K).  On the
//    cycle s stays an integer, the subgroup from s wraps iff its wrap
//    tick jw = (65 - s) mod 65 is below SUB, and the next subgroup starts
//    at (s + SUB) mod 65, so (tgt, D) and s step once per subgroup, with
//    the tick loop's values.  p depends only on the ticks since the last
//    wrap (a wrap sets it to C): it is walked with the tick loop's own
//    ops from that wrap, at most 65 ticks, or from the switch to the cycle
//    (tick 0 with p = 1 for an entry step on it) if no wrap came since.
//  - v4 steps s by its closed form, once per subgroup, and resets p at the
//    tick j where jw == j: p is replayed tick by tick, with v4's factors,
//    from the start of the last subgroup before K that holds such a tick
//    (its ticks before the reset are overwritten by it), or from tick 0 if
//    none does.  For an entry step in 0..64 a subgroup resets at least
//    once every 65 ticks, so that is at most 64 + SUB ticks.
// W2 (v3 only): (tgt, D) step by kabl2's rule instead of the wrap seen in
// the subgroup: they move to the next cycle iff the step after the
// subgroup, s', is 0 or s' >= 66 - SUB (kabl.cu's recur2 rows); p and s
// still walk v3's chain.
template <int SUB, int VER, bool W2 = false>
__device__ __forceinline__ void replay(int K, float msr, float msi,
                                       float mult, float& zr, float& zi,
                                       float& tgt, float& D, float& s,
                                       float& p) {
  const float C = 63.f / 64.f;
  p = 1.f;
  if constexpr (VER == 4) {
    int kr = -1;        // the last subgroup before K that resets p
    float sr = 0.f;     // its entry step
    const float s0 = s;
#pragma unroll 1
    for (int k = 0; k < K; ++k) {
      const float tgtm = tgt * mult;
      const float G1 = tgtm - tgt;
      const bool at0 = s == 0.f;
      const float jw = at0 ? 0.f : 65.f - s;
      const bool w_last = jw <= (float)(SUB - 1);
      if (w_last && jw >= 0.f && jw == floorf(jw)) {   // jw in 0..SUB-1
        kr = k;
        sr = s;
      }
      const float nzr = zr * msr - zi * msi;
      const float nzi = zr * msi + zi * msr;
      zr = nzr;
      zi = nzi;
      tgt = w_last ? tgtm : tgt;
      D = w_last ? -G1 : D;
      const float t = s + (float)SUB;
      s = t >= 65.f ? t - 65.f : t;
    }
    float sk = kr >= 0 ? sr : s0;
#pragma unroll 1
    for (int k = kr >= 0 ? kr : 0; k < K; ++k) {
      const bool at0 = sk == 0.f;
      const float jw = at0 ? 0.f : 65.f - sk;
      const float basef = sk * (-1.f / 64.f);
      const float addf = at0 ? 0.f : 65.f / 64.f;
#pragma unroll 8
      for (int j = 0; j < SUB; ++j) {
        const bool wfb = jw <= (float)j;
        const float cjb = basef + (63.f - (float)j) * (1.f / 64.f);
        const float f = cjb + (wfb ? addf : 0.f);
        p = (jw == (float)j) ? C : p * f;
      }
      const float t = sk + (float)SUB;
      sk = t >= 65.f ? t - 65.f : t;
    }
  } else {
    // (a) off the cycle: whole subgroups of the kernel's own tick loop
    int k = 0;
#pragma unroll 1
    for (; k < K && !(s == floorf(s) && s >= 0.f && s <= 64.f); ++k) {
      const float tgtm = tgt * mult;
      const float G1 = tgtm - tgt;
      const float D2 = tgt - tgtm;
      bool wrapped = false;
#pragma unroll 8
      for (int j = 0; j < SUB; ++j) {
        const bool wrap = s == 0.f;
        wrapped = wrapped || wrap;
        p = wrap ? C : p * (1.f - (s + 1.f) / 64.f);
        s = s < 64.f ? s + 1.f : 0.f;
      }
      const float nzr = zr * msr - zi * msi;
      const float nzi = zr * msi + zi * msr;
      zr = nzr;
      zi = nzi;
      const bool w = W2 ? (s == 0.f || s >= 66.f - (float)SUB) : wrapped;
      tgt = w ? tgtm : tgt;
      D = w ? (VER == 2 ? D2 : -G1) : D;
    }
    // (b) on the cycle (s an integer in 0..64, and so it stays): the step
    // and the wrap once per subgroup, as v4 steps them.  tw and sw are the
    // tick and the step p is walked from: the last wrap, else the switch.
    int tw = k * SUB;
    float sw = s;
#pragma unroll 1
    for (; k < K; ++k) {
      const float tgtm = tgt * mult;
      const float G1 = tgtm - tgt;
      const float D2 = tgt - tgtm;
      const float jw = s == 0.f ? 0.f : 65.f - s;   // the tick s is 0
      const bool wrapped = jw <= (float)(SUB - 1);
      if (wrapped) {
        tw = k * SUB + (int)jw;
        sw = 0.f;
      }
      const float nzr = zr * msr - zi * msi;
      const float nzi = zr * msi + zi * msr;
      zr = nzr;
      zi = nzi;
      const float t = s + (float)SUB;
      s = t >= 65.f ? t - 65.f : t;
      const bool w = W2 ? (s == 0.f || s >= 66.f - (float)SUB) : wrapped;
      tgt = w ? tgtm : tgt;
      D = w ? (VER == 2 ? D2 : -G1) : D;
    }
    // (c) p by the tick loop's own ops from tick tw, at most 65 ticks.  No
    // wrap follows tw before the segment, so the step never passes 64
    // there and its reset to 0 is never taken.
#pragma unroll 1
    for (int i = tw; i < K * SUB; ++i) {
      p = sw == 0.f ? C : p * (1.f - (sw + 1.f) / 64.f);
      sw = sw + 1.f;
    }
  }
}

}  // namespace oscen_additive
