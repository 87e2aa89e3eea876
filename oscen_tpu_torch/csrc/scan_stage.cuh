// A staged input ring for one-thread-per-lane scans (sm_90a).
//
// A scan kernel (K6, K7, K8) runs one chain warp per CUDA block, one
// thread per lane of a time-major [B, V] problem, with the lane's state in
// registers; its per-step work is a serial chain.  Reading x[t] (and each
// per-sample coefficient) from global memory inside that loop puts an L2 /
// HBM latency on the chain every few steps: nothing else on the SM hides it
// (V=256 is 8 blocks on 132 SMs; the twin peaks is 2 lanes of one warp).
//
// The ring takes those loads off the chain, and off the chain warp.  A
// second warp of the block, the producer, brings the block's lanes of
// every per-sample plane into shared memory in chunks of kChunk steps,
// with cp.async, up to kStages - 1 chunks ahead of the chunk the chain
// warp reads; named barriers hand each stage over (FULL: the producer's
// copies of a chunk have landed; EMPTY: the chain warp is done with it).
// So the chain warp's instruction stream holds only its arithmetic, its
// stores and shared-memory loads that depend on no state (scheduled ahead
// of the steps that use them).  A kernel may have the producer derive
// planes from a landed chunk (K8's 1 / (1 + g)) before it signals FULL.
//
// Why cp.async and not TMA or bulk copies: a TMA tensor map needs global
// strides that are multiples of 16 bytes, and a 1D bulk copy a
// 16-byte-aligned start and size; the planes here are [B, V] with any V
// (the twin peaks is V=1 or 2, the echo 1, a ragged V 3 or 33), so a row
// is 4-132 bytes and a chunk's start is rarely aligned.  So the copy is
// picked per shape: a full block of 32 lanes with V % 4 == 0 and 16-byte
// aligned planes (V=256) copies each 128-byte row in 16-byte pieces;
// anything else copies 4-byte elements, which serve every V and every
// B >= 1 (the ragged last chunk copies only t < B).  Row coefficients
// (time stride 0) stay out of the ring: the chain warp loads them once.
//
// Every thread of the chain warp, live lane or not, reaches every barrier,
// so a kernel that uses the ring must not return early for lanes >= V.

#pragma once

#include <cuda_runtime.h>

namespace oscen_stage {

constexpr int kLanes = 32;    // one chain warp, one thread per lane
constexpr int kBlock = 2 * kLanes;   // the chain warp, then the producer
constexpr int kChunk = 32;    // time steps per ring stage (== kLanes)
constexpr int kStages = 3;    // ring depth: 2 chunks in flight ahead
constexpr int kSlotFloats = kStages * kChunk * kLanes;   // one plane

static_assert(kChunk == kLanes, "each thread copies W elements per chunk");

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Named barriers of the two warps (0 is __syncthreads'): FULL and EMPTY
// per stage.
__device__ __forceinline__ int full_id(int k) { return 1 + k % kStages; }
__device__ __forceinline__ int empty_id(int k) {
  return 1 + kStages + k % kStages;
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kBlock) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kBlock) : "memory");
}

// Bytes of dynamic shared memory for `slots` staged planes.
inline size_t ring_bytes(int slots) {
  return (size_t)slots * kSlotFloats * sizeof(float);
}

// The chain warp's side: wait for chunk k's stage; hand it back when done
// (the producer waits only for the stages it will refill).
__device__ __forceinline__ void chunk_ready(int k) { bar_sync(full_id(k)); }

__device__ __forceinline__ void chunk_done(int k, int chunks) {
  if (k + kStages < chunks) bar_arrive(empty_id(k));
}

// The producer warp's side: up to kMaxPlanes [B, V] planes, each staged
// into its own slot of kSlotFloats floats ([kStages][kChunk][kLanes]) of
// `smem`; lane = threadIdx.x - kLanes.
template <int kMaxPlanes>
struct Producer {
  const float* src[kMaxPlanes];
  float* base;         // slot p at base + p * kSlotFloats
  int planes;          // staged planes
  int V, B, l0, W;     // the block's lanes l0 .. l0 + W - 1
  int lane;
  int t_first, j_first, dt, dj;   // this thread's 4-byte copy pattern
  bool vec16;          // whole 128-byte rows in 16-byte pieces

  __device__ void init(float* smem, const float* const* planes_src,
                       int n_planes, int V_, int B_, int l0_) {
    planes = n_planes;
    V = V_;
    B = B_;
    l0 = l0_;
    W = min(kLanes, V - l0);
    lane = threadIdx.x - kLanes;
#pragma unroll
    for (int p = 0; p < kMaxPlanes; ++p)
      src[p] = p < n_planes ? planes_src[p] : nullptr;
    base = smem;
    // the chunk's W * kChunk elements e = (t, j), row-major, are copied
    // by thread e % 32: this thread's first is (lane / W, lane % W), and
    // each next one 32 elements on
    t_first = lane / W;
    j_first = lane % W;
    dt = kLanes / W;
    dj = kLanes % W;
    // a full block of 32 lanes whose rows start 16-byte aligned in every
    // plane copies each 128-byte row as 8 pieces of 16 bytes: 8 copies
    // per thread and plane instead of 32
    vec16 = W == kLanes && V % 4 == 0;
#pragma unroll
    for (int p = 0; p < kMaxPlanes; ++p)
      if (p < n_planes)
        vec16 = vec16 && (reinterpret_cast<size_t>(planes_src[p]) & 15) == 0;
  }

  // This thread's copies of chunk k (all planes), committed as one group.
  __device__ void issue(int k) {
    const int t0 = k * kChunk;
    const int stage = (k % kStages) * kChunk * kLanes;
    if (vec16) {
      const int row = lane / 8, col = (lane % 8) * 4;
#pragma unroll
      for (int p = 0; p < kMaxPlanes; ++p) {
        if (p >= planes) break;
        float* dst = base + p * kSlotFloats + stage + row * kLanes + col;
        const float* from = src[p] + (size_t)(t0 + row) * V + l0 + col;
#pragma unroll
        for (int m = 0; m < kChunk / 4; ++m)
          if (t0 + row + 4 * m < B)
            cp_async16(dst + 4 * m * kLanes, from + (size_t)4 * m * V);
      }
    } else {
#pragma unroll
      for (int p = 0; p < kMaxPlanes; ++p) {   // static p: registers
        if (p >= planes) break;
        int t = t_first, j = j_first;
        for (int m = 0; m < W; ++m) {
          if (t0 + t < B)
            cp_async4(base + p * kSlotFloats + stage + t * kLanes + j,
                      src[p] + (size_t)(t0 + t) * V + l0 + j);
          t += dt;
          j += dj;
          if (j >= W) {
            j -= W;
            ++t;
          }
        }
      }
    }
    commit();
  }

  // The producer's whole run: chunk k goes into the stage chunk
  // k - kStages used once the chain warp has handed that back; when chunk
  // k's copies have landed (at most one newer chunk still in flight),
  // `landed(k)` derives what it derives and FULL is signalled.  Copies the
  // caller issued before run() (e.g. a table) land with chunk 0.
  template <class Landed>
  __device__ void run(int chunks, Landed&& landed) {
    for (int k = 0; k < chunks; ++k) {
      if (k >= kStages) bar_sync(empty_id(k));
      issue(k);
      if (k >= 1) {
        wait_groups<1>();
        __syncwarp();   // every producer thread's copies, to all of them
        landed(k - 1);
        bar_arrive(full_id(k - 1));
      }
    }
    wait_groups<0>();
    __syncwarp();
    landed(chunks - 1);
    bar_arrive(full_id(chunks - 1));
  }
};

// The chain warp's loop over one staged chunk.  kP planes are staged
// (x first, then each per-sample coefficient); row coefficients stay in
// the body's registers.  A chunk's steps read their inputs from registers
// that were loaded from shared memory a group of kGroup steps ahead
// (double-buffered), so no load waits inside the chain; `body.step(in,
// t)` runs step t of the chunk on the staged inputs in[0 .. kP - 1].
constexpr int kGroup = 8;

template <int kP>
__device__ __forceinline__ void load_group(float (&dst)[kP][kGroup],
                                           const float* const (&src)[kP],
                                           int t0) {
#pragma unroll
  for (int p = 0; p < kP; ++p)
#pragma unroll
    for (int j = 0; j < kGroup; ++j) dst[p][j] = src[p][(t0 + j) * kLanes];
}

template <int kP, class Body>
__device__ __forceinline__ void run_chunk(const float* const (&src)[kP],
                                          int n, Body& body) {
  if (n == kChunk) {
    float cur[kP][kGroup], nxt[kP][kGroup];
    load_group<kP>(cur, src, 0);
#pragma unroll 1
    for (int t0 = 0; t0 < kChunk; t0 += kGroup) {
      // the next group (the first again after the last: a harmless read)
      load_group<kP>(nxt, src, (t0 + kGroup) % kChunk);
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        float in[kP];
#pragma unroll
        for (int p = 0; p < kP; ++p) in[p] = cur[p][j];
        body.step(in, t0 + j);
      }
#pragma unroll
      for (int p = 0; p < kP; ++p)
#pragma unroll
        for (int j = 0; j < kGroup; ++j) cur[p][j] = nxt[p][j];
    }
  } else {   // the ragged last chunk
    for (int t = 0; t < n; ++t) {
      float in[kP];
#pragma unroll
      for (int p = 0; p < kP; ++p) in[p] = src[p][t * kLanes];
      body.step(in, t);
    }
  }
}

// This lane's pointers into chunk c's stage of the kP staged slots.
template <int kP>
__device__ __forceinline__ void stage_ptrs(const float* smem, int c,
                                           const float* (&src)[kP]) {
  const int off = (c % kStages) * kChunk * kLanes + threadIdx.x;
#pragma unroll
  for (int p = 0; p < kP; ++p) src[p] = smem + p * kSlotFloats + off;
}

}  // namespace oscen_stage
