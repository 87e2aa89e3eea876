// The short exact wrap shared by phase.cu (K6, against q - floorf(q)) and
// fm.cu (K12, against q - truncf(q)), and its sweep over every float32
// pattern.
//
// With q = p + dt, q - floorf(q) and q - truncf(q) are the same value on
// [+0, 2): q on [+0, 1), and q - 1 on [1, 2), exact by Sterbenz's lemma.
// So the step is q - c with c = (q >= 1) as 1.0f or 0.0f from one FSET:
// the chain is FADD -> FSET -> FADD, 14.5 cycles a step against FRND's
// 25.5 (a compare into a predicate and a select, FSETP -> FSEL, cost 22.5:
// tools/scanprobe.py's latency rows).  Every other q (negative, -0, >= 2,
// inf, NaN) sets bit 31 or bit 30 of its pattern (kOutside).

#pragma once

#include <cuda_runtime.h>

namespace oscen_wrap {

// the bits of a q outside [+0, 2): the sign (negatives, -0) or bit 30
// (exponent >= 128: q >= 2, inf, NaN)
constexpr unsigned kOutside = 0xC0000000u;

// q - (q >= 1 as 1.0f or 0.0f): the reference's wrap on [+0, 2)
__device__ __forceinline__ float short_wrap(float q) {
  float c;   // one FSET, no predicate
  asm("set.ge.f32.f32 %0, %1, 0f3F800000;" : "=f"(c) : "f"(q));
  return q - c;
}

constexpr int kSweepBlocks = 132 * 16, kSweepThreads = 256;

// The short wrap over every float32 bit pattern q: counts[0] += patterns
// where the kernel's wrap (the short one on [+0, 2), the reference
// wrap(q) elsewhere) differs from wrap(q) bit for bit (a NaN is equal only
// to its own pattern), counts[1] += patterns the short wrap takes.
template <class Wrap>
__global__ void __launch_bounds__(kSweepThreads)
wrap_sweep(unsigned long long* counts, Wrap wrap) {
  unsigned long long wrong = 0, taken = 0;
  const unsigned long long stride =
      (unsigned long long)kSweepBlocks * kSweepThreads;
  for (unsigned long long k = blockIdx.x * kSweepThreads + threadIdx.x;
       k < (1ull << 32); k += stride) {
    const float q = __uint_as_float((unsigned)k);
    const bool short_path = ((unsigned)k & kOutside) == 0u;
    const float ref = wrap(q);
    const float got = short_path ? short_wrap(q) : ref;
    wrong += __float_as_uint(got) != __float_as_uint(ref);
    taken += short_path;
  }
  for (int o = 16; o > 0; o /= 2) {
    wrong += __shfl_down_sync(0xffffffffu, wrong, o);
    taken += __shfl_down_sync(0xffffffffu, taken, o);
  }
  if ((threadIdx.x & 31) == 0) {
    if (wrong) atomicAdd(&counts[0], wrong);
    atomicAdd(&counts[1], taken);
  }
}

// Launch the sweep on `stream`; returns cudaGetLastError().
template <class Wrap>
int launch_wrap_sweep(unsigned long long* counts, Wrap wrap, void* stream) {
  wrap_sweep<<<kSweepBlocks, kSweepThreads, 0, (cudaStream_t)stream>>>(
      counts, wrap);
  return (int)cudaGetLastError();
}

}  // namespace oscen_wrap
