// Ablations of the fused additive voice (K16, tick-major) for Hopper
// (sm_90a): the cost-attribution tools of the v3 kernel (K3, and through
// it K1).
//
// Replaces the TPU kernels of the JAX package's ablation tools
//   tools/kabl.py:129  (make_kernel :22)  full, no_amp, no_rows, no_env,
//                                         no_reduce;
//   tools/kabl2.py:185 (make_kernel :26)  base, recur, loads, dot32, dot4,
//                                         v4, v5;
//   tools/kabl3.py:152 (make_kernel :21)  v3b, v3b64, bf16_vpu, bf16_mxu;
//   tools/kabl4.py:193 (make_kernel :35)  v3b, norows, noamp, noim, nored,
//                                         noout, defmix, defmix64;
//   tools/kabl5.py:239 (make_v3b :41)     v3b;
//   tools/kabl6.py:157 (make_kernel :37)  v5, v5s64, u128 (its v3b and v4
//                                         are K3 and K1 of csrc/additive.cu).
// Every variant is one steady block of the v3 body for every voice: the
// envelope rows, amp = r2*G1 + (r1*D + tgt), the rotation im = zr*3m_i^j +
// zi*3m_r^j, the product summed over the harmonics, the voices mixed into
// y [B], with one cost removed or one mechanism swapped.
//
// Two kernels, one body (kabl_body):
//  - kabl_tick_kernel<SUB, ROWS, AMP, IM, RED, OUT, PREC> (kernel A): K3's
//    layout, one warp per voice, one lane per harmonic (H = 32), two warps
//    per CUDA block.  Each TPU ablation is a compile-time switch;
//  - kabl_mma_kernel<...> (kernel B): the same body, eight warps (voices)
//    per block, for the variants whose TPU form is an MXU product.  Its
//    analogue here is mma.sync.m16n8k16 (bf16 in, f32 accumulate) over the
//    block's 8 voices as the N dimension:
//      one-hot rows (dot32, dot4, v4, v5): tbl [4B, 72 -> 80] x one-hot
//        [80, 8 voices] built from step in registers;
//      bf16_mxu: a block-diagonal ones matrix [SUB, SUB * 32] x the bf16
//        products staged in shared memory [SUB * 32, 8 voices].  Only the
//        diagonal band of k-tiles is issued (the others multiply zeros).
//
// What bounds it on the card: as K1 and K3, a serial chain per voice
// (envelope rows and rotation, ~23 float ops per tick and lane) and only 256
// voices = 256 warps for 132 SMs, so latency, not bytes (7 [H, V] planes in,
// [B] out) or peak ops.  The design keeps every variant on K3's layout so
// that the deltas price one mechanism each on this card:
//  - RED: the TPU's per-tick sublane Sum_H is the warp reduce-scatter of
//    K1 (32 ticks per 31 shuffles), its stages spelled out so that the
//    tick values stay in registers (K1's loop form is not unrolled by nvcc
//    and keeps them in local memory; see reduce_scatter); lane0 (nored,
//    no_reduce) takes lane 0's
//    product; defer (defmix, defmix64) keeps every lane's product of a body
//    of U ticks in shared memory and finishes the U ticks with one
//    block-level pairwise tree.  That finish does not use the tensor
//    cores: an f32 ones-product there runs in TF32 and would round the
//    partials to 10 mantissa bits.
//  - ROWS: recur is v3's serial chain; const / fixed / base are the tools'
//    constant rows with their own step and w_last rules; loads reads rows
//    from a zero-filled shared-memory table; scan (kabl6 v5) computes the
//    SUB rows of a subgroup at once, lane j row j, by a log-step
//    multiplicative __shfl_up_sync scan in the Hillis-Steele order of
//    kabl6.py:85-88 (the TPU's pltpu.roll), and fetches each tick's row with
//    __shfl_sync (the TPU's per-tick sublane slice).
//  - PREC bf16: rounds where kabl3.py:71-89 does (astype(bf16) before each
//    product, f32 for the reduce), with __hmul / __hadd, never __hfma, so
//    the kernel rounds as PyTorch's separate bf16 ops.
//  - OUT drop (noout) and the discarded dots (dot32, dot4): nvcc would delete
//    work that nothing reads.  noout folds every per-tick sum into a sink as
//    sink + x * 0.0f (not foldable without fast-math: x may be inf or NaN)
//    and stores the sinks to a keep-alive buffer, and stores y = 0 + Y00 *
//    0 per body as the tool does (kabl4.py:149-150); the dots are inline
//    asm volatile, so none is removed, and their results go to shared
//    memory ("keep alive" stores, kabl2.py:79, :108).
//  - The voice mix is K1's fixed-order finish (its code): each block stores
//    its warps' row sum, the last block of each group of 16 (a ticket) sums
//    its group in block order, the last group finisher sums the group rows,
//    float4 columns with 32 loads in flight per thread.
//    No float atomics.  (kabl6's u128 is U = 128: a TPU unroll knob; here U
//    only groups the y stores of defer and drop, so u128 is v5's launch.)
//
// Numerics: built with --fmad=false.  Every f32 state plane (oscillator,
// target, step) equals the plain PyTorch version (ops/cuda/kabl.py) bit for
// bit; y differs by the order of the harmonic and voice sums (and, for the
// mma variants, the tensor cores' f32 accumulation).
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMixGroup = 16;
constexpr int kTblCols = 72;   // the tools' PAD: one-hot table width
constexpr int kTblTiles = 5;   // 72 padded to 80 = 5 k-tiles of 16
constexpr int kMmaWarps = 8;   // voices per block of kernel B = mma's N
constexpr int kTickWarps = 2;  // voices per block of kernel A, as K1

// ROWS: how the envelope rows r1, r2 of a tick are made
constexpr int kRecur = 0;   // v3's per-tick chain, w_last = wrapped
constexpr int kRecur2 = 1;  // the same chain, kabl2's w_last rule, no s step
constexpr int kFixed = 2;   // kabl no_rows: p*0.5, p*0.25; s never advances
constexpr int kConst = 3;   // kabl4 norows: 0.9-0.001j, 0.001j
constexpr int kBase = 4;    // kabl2 base: p*0.5, p*0.25, s += SUB mod 65
constexpr int kLoads = 5;   // kabl2 loads: a zero-filled shared table
constexpr int kScan = 6;    // kabl6 v5: the segmented cumprod scan
constexpr int kDot32 = 7;   // base rows + a discarded one-hot dot per subgroup
constexpr int kDot4 = 8;    // base rows + 4 discarded whole-block dots
constexpr int kMmaSub = 9;  // kabl2 v4: rows from a dot per subgroup
constexpr int kMmaAll = 10; // kabl2 v5: rows from 4 whole-block dots
// AMP
constexpr int kAmpFull = 0, kAmpTgt = 1, kAmpNone = 2;
// IM
constexpr int kImRot = 0, kImZr = 1;
// RED
constexpr int kRedSum = 0, kRedLane0 = 1, kRedDefer = 2, kRedMma = 3;
// OUT
constexpr int kOutStore = 0, kOutDrop = 1;
// PREC
constexpr int kF32 = 0, kBf16 = 1;

struct Args {
  const float* osc_re;
  const float* osc_im;
  const float* mul_re;
  const float* mul_im;
  const float* cur;
  const float* tgt;
  const float* mult;
  const float* step;           // [V] (the tools' [1, V])
  const __nv_bfloat16* tbl;    // [4B, 72] one-hot table, or null
  float* y;                    // [B] (the tools' [B, 1])
  float* part;                 // [blocks + groups, B] mix scratch
  unsigned* cnt;               // [1 + groups] tickets, zero between launches
  float* keep;                 // [32, V] keep-alive sinks (OUT drop)
  float* osc_re_out;
  float* osc_im_out;
  float* cur_out;
  float* tgt_out;
  float* step_out;
  int V, B, U, cur_in;
};

// One stage of the reduce-scatter: the lanes whose bit HALF is set keep
// the upper half of the ticks and receive it from their partner.
template <int HALF>
__device__ __forceinline__ void rs_stage(float (&vals)[32], int lane) {
  const bool upper = (lane & HALF) != 0;
#pragma unroll
  for (int k = 0; k < HALF; ++k) {
    const float send = upper ? vals[k] : vals[k + HALF];
    const float keep = upper ? vals[k + HALF] : vals[k];
    vals[k] = keep + __shfl_xor_sync(kFull, send, HALF);
  }
}

// Sum vals[0..32) over the 32 lanes; lane L ends with the sum of tick L
// (K1's reduce-scatter: 31 shuffles for 32 ticks, in its order).  The
// stages are spelled out so that every index is a constant: K1's loop
// form (c = N; c > 1; c /= 2) is not unrolled by nvcc, and its dynamic
// indices put vals in local memory (LDL / STL in K1's SASS).
__device__ __forceinline__ float reduce_scatter(float (&vals)[32], int lane) {
  rs_stage<16>(vals, lane);
  rs_stage<8>(vals, lane);
  rs_stage<4>(vals, lane);
  rs_stage<2>(vals, lane);
  rs_stage<1>(vals, lane);
  return vals[0];
}

// The block's row of n ticks from t0: red[w][i] summed over the warps in
// warp order into part[blockIdx.x][t0 + i].
__device__ __forceinline__ void block_row(float (*red)[33], int n, int t0,
                                          const Args& A) {
  __syncthreads();
  if (threadIdx.x < n) {
    float acc = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w)
      acc += red[w][threadIdx.x];
    A.part[(size_t)blockIdx.x * A.B + t0 + threadIdx.x] = acc;
  }
  __syncthreads();
}

// Sum n rows of B floats (row stride B) in row order, 4 ticks per load,
// for the float4 columns c0 and c1 (c1 < 0: none): K1's sum_rows2.  The
// rows were written by other blocks: read from L2 (__ldcg), up to
// kMixGroup rows of both columns in flight before any is added.
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

// The fixed-order voice mix (K1's finish): called by every thread of
// every block after its rows are stored.  The last block of each group of
// kMixGroup blocks (a ticket) sums its group's rows in block order, the
// last group finisher sums the group rows in group order into y.
__device__ void finish_mix(const Args& A) {
  __shared__ int s_last;
  const int B = A.B;
  const int nb = gridDim.x;
  const int ng = (nb + kMixGroup - 1) / kMixGroup;
  const int g = blockIdx.x / kMixGroup;
  const int n = min(kMixGroup, nb - g * kMixGroup);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(&A.cnt[1 + g], 1u) == (unsigned)(n - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int cols = B / 4;
  const int step = 2 * blockDim.x;
  float4* grow = reinterpret_cast<float4*>(A.part + (size_t)(nb + g) * B);
  for (int c = threadIdx.x; c < cols; c += step) {
    const int c1 = c + blockDim.x < cols ? c + blockDim.x : -1;
    float4 a0, a1;
    sum_rows2(A.part + (size_t)g * kMixGroup * B, n, B, c, c1, a0, a1);
    grow[c] = a0;
    if (c1 >= 0) grow[c1] = a1;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    A.cnt[1 + g] = 0;  // ready for the next launch on this stream
    s_last = atomicAdd(&A.cnt[0], 1u) == (unsigned)(ng - 1);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  float4* y = reinterpret_cast<float4*>(A.y);
  for (int c = threadIdx.x; c < cols; c += step) {
    const int c1 = c + blockDim.x < cols ? c + blockDim.x : -1;
    float4 a0, a1;
    sum_rows2(A.part + (size_t)nb * B, ng, B, c, c1, a0, a1);
    y[c] = a0;
    if (c1 >= 0) y[c1] = a1;
  }
  if (threadIdx.x == 0) A.cnt[0] = 0;
}

// ---- tensor cores: mma.sync m16n8k16, bf16 x bf16 -> f32 --------------
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

// D += A B with A 16x16 (row), B 16x8 (col).  volatile: a product whose
// result nothing reads is kept (the discarded dots of kabl2).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two neighbouring bf16 of the [rows, 72] table (0 past column 71).
__device__ __forceinline__ unsigned tbl_pair(const __nv_bfloat16* tbl,
                                             int row, int col) {
  if (col >= kTblCols) return 0u;
  return __ldg(reinterpret_cast<const unsigned*>(tbl + (size_t)row *
                                                 kTblCols + col));
}

// One 16-row tile of tbl [r0, r0 + 16) times the one-hot [80, 8 voices]
// (fragment oh, built from step): d[i] is row r0 + gid (+8 for i >= 2),
// voice tig * 2 + (i & 1).
__device__ __forceinline__ void onehot_tile(const __nv_bfloat16* tbl, int r0,
                                            const unsigned (&oh)[kTblTiles][2],
                                            int lane, float (&d)[4]) {
  const int gid = lane >> 2, tig = lane & 3;
  d[0] = d[1] = d[2] = d[3] = 0.f;
#pragma unroll
  for (int kt = 0; kt < kTblTiles; ++kt) {
    const int c = kt * 16 + tig * 2;
    const unsigned a[4] = {tbl_pair(tbl, r0 + gid, c),
                           tbl_pair(tbl, r0 + gid + 8, c),
                           tbl_pair(tbl, r0 + gid, c + 8),
                           tbl_pair(tbl, r0 + gid + 8, c + 8)};
    mma_bf16(d, a, oh[kt]);
  }
}

// Store a [16, 8] tile at rows r0.. of a [rows, 8] float array.
__device__ __forceinline__ void store_tile(float* s, int r0, int lane,
                                           const float (&d)[4]) {
  const int gid = lane >> 2, tig = lane & 3;
  s[(r0 + gid) * 8 + tig * 2] = d[0];
  s[(r0 + gid) * 8 + tig * 2 + 1] = d[1];
  s[(r0 + gid + 8) * 8 + tig * 2] = d[2];
  s[(r0 + gid + 8) * 8 + tig * 2 + 1] = d[3];
}

// The segmented cumprod scan of kabl6 rows_for for one subgroup: lane j
// holds tick j (and j + 32 at SUB = 64).  am, ap: post- and pre-wrap
// factors, scanned in place in the Hillis-Steele order of the tool
// (x[J] * x[J - sh] for J >= sh, sh = 1, 2, 4, ...).
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

// One steady block of the v3 body with the variant's switches (see the
// file comment).  Warp = voice, lane = harmonic.
template <int SUB, int ROWS, int AMP, int IM, int RED, int OUT, int PREC>
__device__ __forceinline__ void kabl_body(const Args& A) {
  static_assert(SUB == 32 || SUB == 64, "SUB is 32 or 64");
  static_assert(PREC == kF32 || (AMP == kAmpFull && IM == kImRot),
                "the bf16 variants keep the whole body");
  constexpr bool kOneHot = ROWS >= kDot32;
  extern __shared__ float dyn[];
  __shared__ float red[kMmaWarps][33];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int V = A.V, B = A.B;
  const int v = blockIdx.x * nw + warp;
  const bool live = v < V;
  const int at = lane * V + v;

  float zr = live ? A.osc_re[at] : 0.f;
  float zi = live ? A.osc_im[at] : 0.f;
  const float mr = live ? A.mul_re[at] : 0.f;
  const float mi = live ? A.mul_im[at] : 0.f;
  const float cur0 = live ? A.cur[at] : 0.f;
  const float tgt_in = live ? A.tgt[at] : 0.f;
  const float mult = live ? A.mult[at] : 0.f;
  float s = live ? A.step[v] : 0.f;

  // m^SUB by the recurrence that gives the per-tick powers m^(j+1)
  float msr = mr, msi = mi;
  for (int j = 1; j < SUB; ++j) {
    const float pr = msr, pi = msi;
    msr = pr * mr - pi * mi;
    msi = pr * mi + pi * mr;
  }
  float tgt = (s == 0.f) ? cur0 : tgt_in;
  float D = cur0 - tgt;
  float p = 1.f;
  const float C = 63.f / 64.f;

  // kernel B's one-hot [80, 8 voices] fragment: voice gid of the block,
  // one at row step (astype(int32): truncation)
  unsigned oh[kTblTiles][2];
  if constexpr (kOneHot) {
    const int gid = lane >> 2, tig = lane & 3;
    const int vn = blockIdx.x * nw + gid;
    const int si = vn < V ? (int)A.step[vn] : -1;
#pragma unroll
    for (int kt = 0; kt < kTblTiles; ++kt) {
      const int k0 = kt * 16 + tig * 2;
      oh[kt][0] = pack_bf16(k0 == si, k0 + 1 == si);
      oh[kt][1] = pack_bf16(k0 + 8 == si, k0 + 9 == si);
    }
  }
  float* scr = dyn;  // [rows, 8]: the one-hot products
  if constexpr (ROWS == kLoads) {
    float* t = dyn + warp * 2 * B;
    for (int i = lane; i < 2 * B; i += 32) t[i] = 0.f;
    __syncwarp();
  }
  if constexpr (ROWS == kMmaAll) {
    // kabl2 v5: scr[r] = tbl[r] oh + tbl[2B + r] oh for r < 2B
    for (int m = warp; m < 2 * B / 16; m += nw) {
      float d1[4], d2[4];
      onehot_tile(A.tbl, m * 16, oh, lane, d1);
      onehot_tile(A.tbl, 2 * B + m * 16, oh, lane, d2);
      const float d[4] = {d1[0] + d2[0], d1[1] + d2[1], d1[2] + d2[2],
                          d1[3] + d2[3]};
      store_tile(scr, m * 16, lane, d);
    }
    __syncthreads();
  }
  if constexpr (ROWS == kDot4) {
    // kabl2 dot4: 4 chunks of 2B/4 rows summed; rows [0, 4 SUB) stored to
    // keep them alive, the rest kept by the volatile mma
    const int cr = B / 2;
    for (int m = warp; m < cr / 16; m += nw) {
      float acc[4], d[4];
      onehot_tile(A.tbl, m * 16, oh, lane, acc);
      for (int c = 1; c < 4; ++c) {
        onehot_tile(A.tbl, c * cr + m * 16, oh, lane, d);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] = acc[i] + d[i];
      }
      if (m * 16 < 4 * SUB) store_tile(scr, m * 16, lane, acc);
    }
    __syncthreads();
  }

  float sink = 0.f, y00 = 0.f;  // OUT drop
  for (int t0 = 0; t0 < B; t0 += SUB) {
    const float tgtm = tgt * mult;
    const float G1 = tgtm - tgt;
    bool wrapped = false;  // a wrap seen in this subgroup so far
    if constexpr (ROWS == kDot32 || ROWS == kMmaSub) {
      // one dot of 4 SUB = 128 table rows per subgroup, warp = m-tile
      __syncthreads();
      float d[4];
      onehot_tile(A.tbl, (t0 / SUB) * 4 * SUB + warp * 16, oh, lane, d);
      store_tile(scr, warp * 16, lane, d);
      __syncthreads();
    }
    // kabl6 v5: the subgroup's rows at once, lane j = tick j (+32)
    float r1lo = 0.f, r1hi = 0.f, r2lo = 0.f, r2hi = 0.f;
    bool w_scan = false;
    float p_scan = 0.f, s_scan = 0.f;
    if constexpr (ROWS == kScan) {
      const bool s0z = s == 0.f;
      float am[2], ap[2], se[2];
      bool wr[2];
#pragma unroll
      for (int h = 0; h < SUB / 32; ++h) {
        const float S = s + (float)(lane + 32 * h);
        wr[h] = S >= 65.f || s0z;
        const float shift = s0z ? 0.f : 65.f;
        se[h] = wr[h] ? S - shift : S;
        const float a = (63.f - se[h]) * (1.f / 64.f);
        am[h] = wr[h] ? a : 1.f;
        ap[h] = wr[h] ? 1.f : a;
      }
      if constexpr (SUB == 32) {
        am[1] = ap[1] = se[1] = 0.f;
        wr[1] = false;
      }
      scan_mul<SUB>(am[0], am[1], lane);
      scan_mul<SUB>(ap[0], ap[1], lane);
      r1lo = p * (wr[0] ? 0.f : ap[0]);
      r2lo = wr[0] ? 1.f - am[0] : 0.f;
      r1hi = p * (wr[1] ? 0.f : ap[1]);
      r2hi = wr[1] ? 1.f - am[1] : 0.f;
      constexpr int L = SUB / 32 - 1;  // the last tick is lane 31's
      const float p_last = wr[L] ? am[L] : p * ap[L];
      const float s_last = se[L] < 64.f ? se[L] + 1.f : 0.f;
      w_scan = __shfl_sync(kFull, (int)wr[L], 31) != 0;
      p_scan = __shfl_sync(kFull, p_last, 31);
      s_scan = __shfl_sync(kFull, s_last, 31);
    }
    __nv_bfloat16 zrb, zib, tgtb, Db, G1b;
    if constexpr (PREC == kBf16) {
      zrb = __float2bfloat16(zr);
      zib = __float2bfloat16(zi);
      tgtb = __float2bfloat16(tgt);
      Db = __float2bfloat16(D);
      G1b = __float2bfloat16(G1);
    }
    float wr = mr, wi = mi;  // m^(j+1)
#pragma unroll
    for (int c = 0; c < SUB / 32; ++c) {
      float vals[32];
#pragma unroll
      for (int jj = 0; jj < 32; ++jj) {
        const int j = c * 32 + jj;
        float r1 = 0.f, r2 = 0.f;
        if constexpr (ROWS == kRecur || ROWS == kRecur2) {
          const bool wrap = s == 0.f;
          wrapped = wrapped || wrap;
          p = wrap ? C : p * (1.f - (s + 1.f) / 64.f);
          r1 = wrapped ? 0.f : p;
          r2 = wrapped ? 1.f - p : 0.f;
          s = s < 64.f ? s + 1.f : 0.f;
        } else if constexpr (ROWS == kFixed || ROWS == kBase ||
                             ROWS == kDot32 || ROWS == kDot4) {
          r1 = p * 0.5f;
          r2 = p * 0.25f;
        } else if constexpr (ROWS == kConst) {
          r1 = (float)(0.9 - 0.001 * j);
          r2 = (float)(0.001 * j);
        } else if constexpr (ROWS == kLoads) {
          const float* t = dyn + warp * 2 * B;
          r1 = t[t0 + j];
          r2 = t[B + t0 + j];
        } else if constexpr (ROWS == kScan) {
          r1 = __shfl_sync(kFull, j < 32 ? r1lo : r1hi, j & 31);
          r2 = __shfl_sync(kFull, j < 32 ? r2lo : r2hi, j & 31);
        } else if constexpr (ROWS == kMmaSub) {
          r1 = scr[j * 8 + warp] + scr[(2 * SUB + j) * 8 + warp];
          r2 = scr[(SUB + j) * 8 + warp] + scr[(3 * SUB + j) * 8 + warp];
        } else {  // kMmaAll
          r1 = scr[(t0 + j) * 8 + warp];
          r2 = scr[(B + t0 + j) * 8 + warp];
        }
        float prod;
        if constexpr (PREC == kBf16) {
          const __nv_bfloat16 mi3 = __float2bfloat16(wi * 3.f);
          const __nv_bfloat16 mr3 = __float2bfloat16(wr * 3.f);
          const __nv_bfloat16 ampb =
              __hadd(__hmul(__float2bfloat16(r2), G1b),
                     __hadd(__hmul(__float2bfloat16(r1), Db), tgtb));
          const __nv_bfloat16 imb = __hadd(__hmul(zrb, mi3),
                                           __hmul(zib, mr3));
          const __nv_bfloat16 pb = __hmul(imb, ampb);
          prod = __bfloat162float(pb);
          if constexpr (RED == kRedMma)
            reinterpret_cast<__nv_bfloat16*>(dyn)[warp * SUB * 32 + j * 32 +
                                                  lane] = pb;
        } else {
          float amp = tgt;
          if constexpr (AMP == kAmpFull) amp = r2 * G1 + (r1 * D + tgt);
          float im = zr;
          if constexpr (IM == kImRot) im = zr * (wi * 3.f) + zi * (wr * 3.f);
          prod = AMP == kAmpNone ? im : im * amp;
        }
        vals[jj] = prod;
        if constexpr (RED == kRedDefer)
          dyn[(warp * A.U + (t0 + j) % A.U) * 33 + lane] = prod;
        if constexpr (IM == kImRot) {
          const float pr = wr, pi = wi;
          wr = pr * mr - pi * mi;
          wi = pr * mi + pi * mr;
        }
      }
      const int tc = t0 + c * 32;
      if constexpr (RED == kRedSum && OUT == kOutDrop) {
        const float ysum = reduce_scatter(vals, lane);
        if (tc % A.U == 0) y00 = __shfl_sync(kFull, ysum, 0);
        sink = sink + ysum * 0.f;
        if (v == 0) A.y[tc + lane] = 0.f + y00 * 0.f;
      } else if constexpr (RED == kRedSum) {
        red[warp][lane] = reduce_scatter(vals, lane);
        block_row(red, 32, tc, A);
      } else if constexpr (RED == kRedLane0) {
        if (lane == 0) {
#pragma unroll
          for (int k = 0; k < 32; ++k) red[warp][k] = vals[k];
        }
        block_row(red, 32, tc, A);
      }
    }
    if constexpr (RED == kRedDefer) {
      // defmix: the body's U ticks, each a pairwise tree over the block's
      // 2 warps x 32 lanes of products (kernel A: 64 threads = U)
      if ((t0 + SUB) % A.U == 0) {
        __syncthreads();
        const int t = threadIdx.x;
        if (t < A.U) {
          float x[32 * kTickWarps];
#pragma unroll
          for (int i = 0; i < 32 * kTickWarps; ++i)
            x[i] = dyn[((i / 32) * A.U + t) * 33 + (i % 32)];
#pragma unroll
          for (int w = 16 * kTickWarps; w >= 1; w /= 2)
#pragma unroll
            for (int i = 0; i < w; ++i) x[i] = x[i] + x[i + w];
          A.part[(size_t)blockIdx.x * B + t0 + SUB - A.U + t] = x[0];
        }
        __syncthreads();
      }
    }
    if constexpr (RED == kRedMma) {
      // bf16_mxu: Y[tick, voice] = ones_bd [SUB, SUB*32] x products
      // [SUB*32, 8 voices], f32 accumulation; only the diagonal band
      __syncthreads();
      const __nv_bfloat16* bn = reinterpret_cast<const __nv_bfloat16*>(dyn);
      float* yt = dyn + 8 * SUB * 32 / 2;  // after the bf16 staging
      if (warp < SUB / 16) {
        const int gid = lane >> 2, tig = lane & 3;
        const int row0 = warp * 16;  // ticks row0 .. row0 + 15
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        for (int kt = 0; kt < 32; ++kt) {
          const int k0 = row0 * 32 + kt * 16 + tig * 2;
          auto one = [&](int r, int k) { return (k / 32 == row0 + r) ? 1.f
                                                                      : 0.f; };
          const unsigned a[4] = {
              pack_bf16(one(gid, k0), one(gid, k0 + 1)),
              pack_bf16(one(gid + 8, k0), one(gid + 8, k0 + 1)),
              pack_bf16(one(gid, k0 + 8), one(gid, k0 + 9)),
              pack_bf16(one(gid + 8, k0 + 8), one(gid + 8, k0 + 9))};
          const unsigned b[2] = {
              *reinterpret_cast<const unsigned*>(bn + gid * SUB * 32 + k0),
              *reinterpret_cast<const unsigned*>(bn + gid * SUB * 32 + k0 +
                                                 8)};
          mma_bf16(d, a, b);
        }
        store_tile(yt, row0, lane, d);
      }
      __syncthreads();
      if (threadIdx.x < SUB) {
        float acc = 0.f;
        for (int n = 0; n < nw; ++n) acc += yt[threadIdx.x * 8 + n];
        A.part[(size_t)blockIdx.x * B + t0 + threadIdx.x] = acc;
      }
      __syncthreads();
    }

    const float nzr = zr * msr - zi * msi;
    const float nzi = zr * msi + zi * msr;
    zr = nzr;
    zi = nzi;
    bool w_last;
    if constexpr (ROWS == kRecur || ROWS == kFixed) {
      w_last = wrapped;
    } else if constexpr (ROWS == kRecur2) {
      w_last = s == 0.f || s >= 66.f - (float)SUB;
    } else if constexpr (ROWS == kConst) {
      s = s + (float)SUB < 65.f ? s + (float)SUB : s;
      w_last = s == 0.f;
    } else if constexpr (ROWS == kScan) {
      w_last = w_scan;
      p = p_scan;
      s = s_scan;
    } else {  // base, loads and the one-hot rows: kabl2's step rule
      w_last = s == 0.f || s >= 66.f - (float)SUB;
      const float t = s + (float)SUB;
      s = t >= 65.f ? t - 65.f : t;
    }
    tgt = w_last ? tgtm : tgt;
    D = w_last ? -G1 : D;
  }

  if (live) {
    A.osc_re_out[at] = zr;
    A.osc_im_out[at] = zi;
    A.cur_out[at] = A.cur_in ? cur0 : tgt;
    A.tgt_out[at] = tgt;
    if (lane == 0) A.step_out[v] = s;
    if constexpr (OUT == kOutDrop) A.keep[at] = sink;
  }
  if constexpr (OUT == kOutStore) finish_mix(A);
}

template <int SUB, int ROWS, int AMP, int IM, int RED, int OUT, int PREC>
__global__ void __launch_bounds__(32 * kTickWarps) kabl_tick_kernel(Args A) {
  kabl_body<SUB, ROWS, AMP, IM, RED, OUT, PREC>(A);
}

template <int SUB, int ROWS, int AMP, int IM, int RED, int OUT, int PREC>
__global__ void __launch_bounds__(32 * kMmaWarps) kabl_mma_kernel(Args A) {
  kabl_body<SUB, ROWS, AMP, IM, RED, OUT, PREC>(A);
}

template <int SUB, int ROWS, int AMP, int IM, int RED, int OUT, int PREC>
int launch(const Args& A, cudaStream_t st) {
  constexpr bool kMma = ROWS >= kDot32 || RED == kRedMma;
  constexpr int nw = kMma ? kMmaWarps : kTickWarps;
  if (A.B % SUB || A.B % 32 || A.U % SUB || A.B % A.U)
    return (int)cudaErrorInvalidValue;
  if (ROWS >= kDot32 && A.tbl == nullptr) return (int)cudaErrorInvalidValue;
  if (RED == kRedDefer && A.U != 32 * nw) return (int)cudaErrorInvalidValue;
  if ((OUT == kOutStore) != (A.part != nullptr && A.cnt != nullptr) ||
      (OUT == kOutDrop) != (A.keep != nullptr))
    return (int)cudaErrorInvalidValue;
  size_t dyn = 0;
  if constexpr (ROWS == kLoads) dyn = (size_t)nw * 2 * A.B * sizeof(float);
  if constexpr (ROWS == kDot32 || ROWS == kDot4 || ROWS == kMmaSub)
    dyn = 4 * SUB * 8 * sizeof(float);
  if constexpr (ROWS == kMmaAll) dyn = (size_t)2 * A.B * 8 * sizeof(float);
  if constexpr (RED == kRedDefer)
    dyn = (size_t)nw * A.U * 33 * sizeof(float);
  if constexpr (RED == kRedMma)
    dyn = 8 * SUB * 32 * sizeof(__nv_bfloat16) + SUB * 8 * sizeof(float);
  void (*kern)(Args);
  if constexpr (kMma)
    kern = kabl_mma_kernel<SUB, ROWS, AMP, IM, RED, OUT, PREC>;
  else
    kern = kabl_tick_kernel<SUB, ROWS, AMP, IM, RED, OUT, PREC>;
  if (dyn > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<(A.V + nw - 1) / nw, 32 * nw, dyn, st>>>(A);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One steady block of variant `variant` (the order of VARIANTS in
// oscen_tpu_torch/ops/cuda/kabl.py, pinned by its tests).  Planes [32, V]
// row-major, step and step_out [V], tbl [4B, 72] bf16 (the one-hot
// variants) or null.  With OUT store y is the [B] mix and part ([blocks +
// groups, B]) and cnt ([1 + groups] zeroed counters, left zeroed; groups =
// ceil(blocks / 16), blocks = ceil(V / warps), 2 warps per block in kernel
// A, 8 in kernel B) are given and keep is null; with OUT drop, part and cnt
// are null and keep is [32, V].  U: the body length (64 or 128); cur_in:
// store the input cur as cur_out (kabl6 v5) instead of the final target.
int oscen_kabl(const float* osc_re, const float* osc_im, const float* mul_re,
               const float* mul_im, const float* cur, const float* tgt,
               const float* mult, const float* step, const void* tbl,
               float* y, float* part, unsigned* cnt, float* keep,
               float* osc_re_out, float* osc_im_out, float* cur_out,
               float* tgt_out, float* step_out, int variant, int V, int B,
               int U, int cur_in, void* stream) {
  if (V < 1 || B < 32 || U < 32) return (int)cudaErrorInvalidValue;
  const Args A{osc_re, osc_im, mul_re, mul_im, cur, tgt, mult, step,
               reinterpret_cast<const __nv_bfloat16*>(tbl), y, part, cnt,
               keep, osc_re_out, osc_im_out, cur_out, tgt_out, step_out, V,
               B, U, cur_in};
  cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {
    // SUB, ROWS, AMP, IM, RED, OUT, PREC
    case 0:  // full
      return launch<32, kRecur, kAmpFull, kImRot, kRedSum, kOutStore, kF32>(A, st);
    case 1:  // no_amp
      return launch<32, kRecur, kAmpTgt, kImRot, kRedSum, kOutStore, kF32>(A, st);
    case 2:  // no_rows
      return launch<32, kFixed, kAmpFull, kImRot, kRedSum, kOutStore, kF32>(A, st);
    case 3:  // no_env
      return launch<32, kRecur, kAmpNone, kImRot, kRedSum, kOutStore, kF32>(A, st);
    case 4:  // no_reduce
      return launch<32, kRecur, kAmpFull, kImRot, kRedLane0, kOutStore, kF32>(A, st);
    case 5:  // base
      return launch<32, kBase, kAmpFull, kImRot, kRedSum, kOutStore, kF32>(A, st);
    case 6:  // recur
      return launch<32, kRecur2, kAmpFull, kImRot, kRedSum, kOutStore, kF32>(A, st);
    case 7:  // loads
      return launch<32, kLoads, kAmpFull, kImRot, kRedSum, kOutStore, kF32>(A, st);
    case 8:  // sub64
      return launch<64, kRecur, kAmpFull, kImRot, kRedSum, kOutStore, kF32>(A, st);
    case 9:  // bf16_vpu
      return launch<32, kRecur, kAmpFull, kImRot, kRedSum, kOutStore, kBf16>(A, st);
    case 10:  // const_rows
      return launch<32, kConst, kAmpFull, kImRot, kRedSum, kOutStore, kF32>(A, st);
    case 11:  // noim
      return launch<32, kRecur, kAmpFull, kImZr, kRedSum, kOutStore, kF32>(A, st);
    case 12:  // noout
      return launch<32, kRecur, kAmpFull, kImRot, kRedSum, kOutDrop, kF32>(A, st);
    case 13:  // defmix
      return launch<32, kRecur, kAmpFull, kImRot, kRedDefer, kOutStore, kF32>(A, st);
    case 14:  // defmix64
      return launch<64, kRecur, kAmpFull, kImRot, kRedDefer, kOutStore, kF32>(A, st);
    case 15:  // scan
      return launch<32, kScan, kAmpFull, kImRot, kRedSum, kOutStore, kF32>(A, st);
    case 16:  // scan64
      return launch<64, kScan, kAmpFull, kImRot, kRedSum, kOutStore, kF32>(A, st);
    case 17:  // dot32
      return launch<32, kDot32, kAmpFull, kImRot, kRedSum, kOutStore, kF32>(A, st);
    case 18:  // dot4
      return launch<32, kDot4, kAmpFull, kImRot, kRedSum, kOutStore, kF32>(A, st);
    case 19:  // onehot_sub
      return launch<32, kMmaSub, kAmpFull, kImRot, kRedSum, kOutStore, kF32>(A, st);
    case 20:  // onehot_all
      return launch<32, kMmaAll, kAmpFull, kImRot, kRedSum, kOutStore, kF32>(A, st);
    case 21:  // bf16_mxu
      return launch<32, kRecur, kAmpFull, kImRot, kRedMma, kOutStore, kBf16>(A, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* oscen_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
