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
// its finishers sum only its columns.

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

}  // namespace oscen_additive
