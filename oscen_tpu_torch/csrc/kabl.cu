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
//    layout, one warp per (voice, time segment), one lane per harmonic (H =
//    32), two warps per CUDA block.  Each TPU ablation is a compile-time
//    switch;
//  - kabl_mma_kernel<...> (kernel B): the same body, eight warps (voices)
//    per block, for the variants whose TPU form is an MXU product.  Its
//    analogue here is mma.sync.m16n8k16 (bf16 in, f32 accumulate) over the
//    block's 8 voices as the N dimension:
//      one-hot rows (dot32, dot4, v4, v5): tbl [4B, 72 -> 80] x one-hot
//        [80, 8 voices] built in registers from the step the block starts
//        from (in every segment);
//      bf16_mxu: a block-diagonal ones matrix [SUB, SUB * 32] x the bf16
//        products staged in shared memory [SUB * 32, 8 voices].  Only the
//        diagonal band of k-tiles is issued (the others multiply zeros).
//
// What bounds it on the card: as K1 and K3, a serial chain per voice
// (envelope rows and rotation, ~23 float ops per tick and lane), so
// latency, not bytes (7 [H, V] planes in, [B] out) or peak ops.  One warp
// per voice gave the tools' 256 voices 256 warps for the card's 528
// schedulers, as K3 had before its segments.  The design keeps every
// variant on K3's layout as it stands, time segments included, so that
// the deltas against K3 and K1 price one mechanism each on this card:
//  - time segments (K1's and K3's, additive_common.cuh): each voice's
//    block is split at subgroup boundaries into S segments, one warp each,
//    S from K1's own rule (segments(): 4 at the tools' V = 256, B = 1024,
//    2 warps or 8 a block), halved further where U groups the y stores
//    (defer, drop) until U divides a segment's ticks.  A segment that
//    starts at subgroup K rebuilds the state the one-warp body holds there
//    (replay_rows) with the body's own ops, so its outputs are those of one
//    warp per voice bit for bit: the oscillator x m^SUB and the cycle's
//    (tgt, D) once per subgroup; the step and p by the ROWS rule: recur
//    is K3's replay() (the step's cycle in closed form, p walked from the
//    last wrap, at most 65 ticks; the tick loop itself off the cycle),
//    recur2 the same with kabl2's (tgt, D) rule, scan walks the step per
//    subgroup and scans p only from the last subgroup whose last tick
//    wraps (kabl_scan.cuh), the others step s once per subgroup and keep
//    p = 1.  The one-hot rows index the table by the block's tick, and
//    loads and v5 keep only the segment's rows in shared memory;
//  - RED: the TPU's per-tick sublane Sum_H is the warp reduce-scatter of
//    K1 (32 ticks per 31 shuffles; additive_common.cuh, its stages template
//    instances, so the tick values stay in registers); lane0 (nored,
//    no_reduce) takes lane 0's product; defer (defmix, defmix64) keeps
//    every lane's product of a body of U ticks in shared memory and
//    finishes the U ticks with one block-level pairwise tree.  That finish
//    does not use the tensor cores: an f32 ones-product there runs in TF32
//    and would round the partials to 10 mantissa bits.
//  - ROWS: recur is v3's serial chain; const / fixed / base are the tools'
//    constant rows with their own step and w_last rules; loads reads rows
//    from a zero-filled shared-memory table; scan (kabl6 v5) computes the
//    SUB rows of a subgroup at once, lane j row j, by a log-step
//    multiplicative shuffle scan in the Hillis-Steele order of
//    kabl6.py:85-88 (the TPU's pltpu.roll; kabl_scan.cuh), and fetches each
//    tick's row with __shfl_sync (the TPU's per-tick sublane slice).
//  - PREC bf16: rounds where kabl3.py:71-89 does (astype(bf16) before each
//    product, f32 for the reduce), with __hmul / __hadd, never __hfma, so
//    the kernel rounds as PyTorch's separate bf16 ops.
//  - OUT drop (noout) and the discarded dots (dot32, dot4): nvcc would delete
//    work that nothing reads.  noout folds every per-tick sum into a sink as
//    sink + x * 0.0f (not foldable without fast-math: x may be inf or NaN)
//    and stores the sinks to a keep-alive buffer, and stores y = 0 + Y00 *
//    0 per body as the tool does (kabl4.py:149-150); the dots are inline
//    asm volatile, so none is removed, and their results go to shared
//    memory ("keep alive" stores, kabl2.py:79, :108); dot4's whole-block
//    dots are shared out over the segments.
//  - The voice mix is K1's fixed-order finish (additive_common.cuh, the
//    same code): each block stores its warps' row sum for its segment's
//    ticks, the last block of each group of 16 (a ticket in the segment's
//    field of the counters) sums its group in block order, the segment's
//    last group finisher sums the group rows, float4 columns with 32 loads
//    in flight per thread.  The tree over the voices of every tick is the
//    one-warp-per-voice kernel's.  No float atomics.  (kabl6's u128 is U =
//    128: a TPU unroll knob; here U only groups the y stores of defer and
//    drop, so u128 is v5's launch.)
//
// Numerics: built with --fmad=false.  Every f32 state plane (oscillator,
// target, step) equals the plain PyTorch version (ops/cuda/kabl.py) bit for
// bit; y differs by the order of the harmonic and voice sums (and, for the
// mma variants, the tensor cores' f32 accumulation), and is the one-warp
// body's bit for bit: the segments keep every tick's harmonic and voice
// trees.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "additive_common.cuh"
#include "kabl_scan.cuh"

namespace {

using oscen_additive::block_row;
using oscen_additive::kFull;
using oscen_additive::reduce_scatter;
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
  int segs;                    // time segments per voice (variant_segments)
};

// The voice mix (K1's, additive_common.cuh): voice block vb's row of n
// ticks from t0, its warps summed in warp order, and the fixed-order
// finish of one segment's columns [T0, T1) of all voice blocks' rows into
// y, counted in the segment's ticket field (32 / segs bits).
__device__ __forceinline__ void kabl_row(float (*red)[33], int n, int t0,
                                         int vb, const Args& A) {
  block_row(red, n, A.part + (size_t)vb * A.B + t0);
}

__device__ void finish_mix(const Args& A, int nb, int vb, int seg, int T0,
                           int T1) {
  float4* y = reinterpret_cast<float4*>(A.y);
  const int bits = 32 / A.segs;
  const unsigned unit = 1u << (bits * seg);
  const unsigned mask = bits == 32 ? 0xffffffffu : (1u << bits) - 1u;
  oscen_additive::finish_rows(A.part, A.cnt, nb, vb, A.B, T0 / 4, T1 / 4,
                              unit, mask,
                              [=](int c, float4 a) { y[c] = a; });
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

// How the step moves at the end of a subgroup for the rows whose step moves
// once per subgroup (fixed, const, base, loads and the one-hot rows): the
// cycle's (tgt, D) move on iff it returns true; s steps by the rule.
template <int SUB, int ROWS>
__device__ __forceinline__ bool step_subgroup(float& s) {
  if constexpr (ROWS == kFixed) {
    return false;  // kabl no_rows: s never advances, no wrap
  } else if constexpr (ROWS == kConst) {
    s = s + (float)SUB < 65.f ? s + (float)SUB : s;
    return s == 0.f;
  } else {  // base, loads and the one-hot rows: kabl2's step rule
    const bool w = s == 0.f || s >= 66.f - (float)SUB;
    const float t = s + (float)SUB;
    s = t >= 65.f ? t - 65.f : t;
    return w;
  }
}

// The state the one-warp body holds at the start of subgroup K, from the
// block-start state (zr, zi, tgt, D, s, p = 1), with the body's ops in its
// order (the file comment): the oscillator x m^SUB and the cycle's (tgt, D)
// once per subgroup, the step and the carry p by the variant's ROWS rule.
template <int SUB, int ROWS>
__device__ __forceinline__ void replay_rows(int K, int lane, float msr,
                                            float msi, float mult, float& zr,
                                            float& zi, float& tgt, float& D,
                                            float& s, float& p) {
  if constexpr (ROWS == kRecur) {
    oscen_additive::replay<SUB, 3>(K, msr, msi, mult, zr, zi, tgt, D, s, p);
  } else if constexpr (ROWS == kRecur2) {
    oscen_additive::replay<SUB, 3, true>(K, msr, msi, mult, zr, zi, tgt, D,
                                         s, p);
  } else {
    const float s0 = s;
#pragma unroll 1
    for (int k = 0; k < K; ++k) {
      const float tgtm = tgt * mult;
      const float G1 = tgtm - tgt;
      const float nzr = zr * msr - zi * msi;
      const float nzi = zr * msi + zi * msr;
      zr = nzr;
      zi = nzi;
      bool w;
      if constexpr (ROWS == kScan)
        w = oscen_kscan::scan_step<SUB>(s);
      else
        w = step_subgroup<SUB, ROWS>(s);
      tgt = w ? tgtm : tgt;
      D = w ? -G1 : D;
    }
    // only the scan rows carry p across subgroups; the others keep p = 1
    if constexpr (ROWS == kScan)
      p = oscen_kscan::scan_replay_p<SUB>(K, s0, lane);
    else
      p = 1.f;
  }
}

// One steady block of the v3 body with the variant's switches over one
// time segment (see the file comment).  Warp = voice, lane = harmonic;
// block b runs voices (b % nb) * nw .. + nw - 1 over segment b / nb.
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
  const int V = A.V, B = A.B, segs = A.segs;
  const int nb = gridDim.x / segs;
  const int vb = blockIdx.x % nb;   // voice block: row vb of the mix
  const int seg = blockIdx.x / nb;
  const int len = B / segs;          // a multiple of SUB (and of U)
  const int T0 = seg * len, T1 = T0 + len;
  const int v = vb * nw + warp;
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
  // one at row step (astype(int32): truncation), the step the block
  // starts from in every segment
  unsigned oh[kTblTiles][2];
  if constexpr (kOneHot) {
    const int gid = lane >> 2, tig = lane & 3;
    const int vn = vb * nw + gid;
    const int si = vn < V ? (int)A.step[vn] : -1;
#pragma unroll
    for (int kt = 0; kt < kTblTiles; ++kt) {
      const int k0 = kt * 16 + tig * 2;
      oh[kt][0] = pack_bf16(k0 == si, k0 + 1 == si);
      oh[kt][1] = pack_bf16(k0 + 8 == si, k0 + 9 == si);
    }
  }
  if (T0 > 0)
    replay_rows<SUB, ROWS>(T0 / SUB, lane, msr, msi, mult, zr, zi, tgt, D, s,
                           p);
  float* scr = dyn;  // [rows, 8]: the one-hot products
  if constexpr (ROWS == kLoads) {
    float* t = dyn + warp * 2 * len;
    for (int i = lane; i < 2 * len; i += 32) t[i] = 0.f;
    __syncwarp();
  }
  if constexpr (ROWS == kMmaAll) {
    // kabl2 v5: scr[r] = tbl[r] oh + tbl[2B + r] oh for the segment's rows
    // r in [T0, T1) and [B + T0, B + T1), kept at r - T0 and len + r - B
    // - T0
    for (int m = warp; m < 2 * len / 16; m += nw) {
      const int r = m * 16 < len ? T0 + m * 16 : B + T0 + m * 16 - len;
      float d1[4], d2[4];
      onehot_tile(A.tbl, r, oh, lane, d1);
      onehot_tile(A.tbl, 2 * B + r, oh, lane, d2);
      const float d[4] = {d1[0] + d2[0], d1[1] + d2[1], d1[2] + d2[2],
                          d1[3] + d2[3]};
      store_tile(scr, m * 16, lane, d);
    }
    __syncthreads();
  }
  if constexpr (ROWS == kDot4) {
    // kabl2 dot4: 4 chunks of 2B/4 rows summed, the segment's share of
    // the chunks' 16-row tiles; its first 4 SUB rows stored to keep them
    // alive, the rest kept by the volatile mma
    const int cr = B / 2;
    const int m0 = seg * (cr / 16 / segs), m1 = m0 + cr / 16 / segs;
    for (int m = m0 + warp; m < m1; m += nw) {
      float acc[4], d[4];
      onehot_tile(A.tbl, m * 16, oh, lane, acc);
      for (int c = 1; c < 4; ++c) {
        onehot_tile(A.tbl, c * cr + m * 16, oh, lane, d);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] = acc[i] + d[i];
      }
      if ((m - m0) * 16 < 4 * SUB) store_tile(scr, (m - m0) * 16, lane, acc);
    }
    __syncthreads();
  }

  float sink = 0.f, y00 = 0.f;  // OUT drop
  for (int t0 = T0; t0 < T1; t0 += SUB) {
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
    float r1s[2], r2s[2];
    float p_scan = 0.f;
    if constexpr (ROWS == kScan)
      p_scan = oscen_kscan::scan_rows<SUB>(s, p, lane, r1s, r2s);
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
          const float* t = dyn + warp * 2 * len;
          r1 = t[t0 - T0 + j];
          r2 = t[len + t0 - T0 + j];
        } else if constexpr (ROWS == kScan) {
          r1 = __shfl_sync(kFull, j < 32 ? r1s[0] : r1s[1], j & 31);
          r2 = __shfl_sync(kFull, j < 32 ? r2s[0] : r2s[1], j & 31);
        } else if constexpr (ROWS == kMmaSub) {
          r1 = scr[j * 8 + warp] + scr[(2 * SUB + j) * 8 + warp];
          r2 = scr[(SUB + j) * 8 + warp] + scr[(3 * SUB + j) * 8 + warp];
        } else {  // kMmaAll
          r1 = scr[(t0 - T0 + j) * 8 + warp];
          r2 = scr[(len + t0 - T0 + j) * 8 + warp];
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
        kabl_row(red, 32, tc, vb, A);
      } else if constexpr (RED == kRedLane0) {
        if (lane == 0) {
#pragma unroll
          for (int k = 0; k < 32; ++k) red[warp][k] = vals[k];
        }
        kabl_row(red, 32, tc, vb, A);
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
          A.part[(size_t)vb * B + t0 + SUB - A.U + t] = x[0];
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
        A.part[(size_t)vb * B + t0 + threadIdx.x] = acc;
      }
      __syncthreads();
    }

    const float nzr = zr * msr - zi * msi;
    const float nzi = zr * msi + zi * msr;
    zr = nzr;
    zi = nzi;
    bool w_last;
    if constexpr (ROWS == kRecur) {
      w_last = wrapped;
    } else if constexpr (ROWS == kRecur2) {
      w_last = s == 0.f || s >= 66.f - (float)SUB;
    } else if constexpr (ROWS == kScan) {
      w_last = oscen_kscan::scan_step<SUB>(s);
      p = p_scan;
    } else {
      w_last = step_subgroup<SUB, ROWS>(s);
    }
    tgt = w_last ? tgtm : tgt;
    D = w_last ? -G1 : D;
  }

  if (live && seg == segs - 1) {
    A.osc_re_out[at] = zr;
    A.osc_im_out[at] = zi;
    A.cur_out[at] = A.cur_in ? cur0 : tgt;
    A.tgt_out[at] = tgt;
    if (lane == 0) A.step_out[v] = s;
    if constexpr (OUT == kOutDrop) A.keep[at] = sink;
  }
  if constexpr (OUT == kOutStore) finish_mix(A, nb, vb, seg, T0, T1);
}

template <int SUB, int ROWS, int AMP, int IM, int RED, int OUT, int PREC>
__global__ void __launch_bounds__(32 * kTickWarps) kabl_tick_kernel(Args A) {
  kabl_body<SUB, ROWS, AMP, IM, RED, OUT, PREC>(A);
}

template <int SUB, int ROWS, int AMP, int IM, int RED, int OUT, int PREC>
__global__ void __launch_bounds__(32 * kMmaWarps) kabl_mma_kernel(Args A) {
  kabl_body<SUB, ROWS, AMP, IM, RED, OUT, PREC>(A);
}

// The time segments per voice of a variant: additive_common.cuh's
// segments() (K1's rule: 4, halved until they divide the B / SUB subgroups
// and their ticket fields hold the voice groups), halved further where U
// groups the y stores (defer, drop) until U divides a segment's ticks.
template <int SUB, int RED, int OUT>
int variant_segments(int V, int B, int U, int nw) {
  int segs = oscen_additive::segments(V, B, SUB, nw);
  if (RED == kRedDefer || OUT == kOutDrop)
    while (segs > 1 && (B / segs) % U) segs /= 2;
  return segs;
}

// Launch the variant, or with segs_only store its segment count there and
// launch nothing.
template <int SUB, int ROWS, int AMP, int IM, int RED, int OUT, int PREC>
int launch(Args A, cudaStream_t st, int* segs_only) {
  constexpr bool kMma = ROWS >= kDot32 || RED == kRedMma;
  constexpr int nw = kMma ? kMmaWarps : kTickWarps;
  if (A.B % SUB || A.B % 32 || A.U % SUB || A.B % A.U)
    return (int)cudaErrorInvalidValue;
  if (RED == kRedDefer && A.U != 32 * nw) return (int)cudaErrorInvalidValue;
  A.segs = variant_segments<SUB, RED, OUT>(A.V, A.B, A.U, nw);
  if (segs_only) {
    *segs_only = A.segs;
    return 0;
  }
  if (ROWS >= kDot32 && A.tbl == nullptr) return (int)cudaErrorInvalidValue;
  if ((OUT == kOutStore) != (A.part != nullptr && A.cnt != nullptr) ||
      (OUT == kOutDrop) != (A.keep != nullptr))
    return (int)cudaErrorInvalidValue;
  const int len = A.B / A.segs;
  size_t dyn = 0;
  if constexpr (ROWS == kLoads) dyn = (size_t)nw * 2 * len * sizeof(float);
  if constexpr (ROWS == kDot32 || ROWS == kDot4 || ROWS == kMmaSub)
    dyn = 4 * SUB * 8 * sizeof(float);
  if constexpr (ROWS == kMmaAll) dyn = (size_t)2 * len * 8 * sizeof(float);
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
  kern<<<((A.V + nw - 1) / nw) * A.segs, 32 * nw, dyn, st>>>(A);
  return (int)cudaGetLastError();
}

// Variant `variant` (the order of VARIANTS in oscen_tpu_torch/ops/cuda/
// kabl.py, pinned by its tests): launched, or with segs_only its segment
// count stored there.
int dispatch(const Args& A, int variant, cudaStream_t st, int* segs_only) {
  switch (variant) {
    // SUB, ROWS, AMP, IM, RED, OUT, PREC
    case 0:  // full
      return launch<32, kRecur, kAmpFull, kImRot, kRedSum, kOutStore, kF32>(A, st, segs_only);
    case 1:  // no_amp
      return launch<32, kRecur, kAmpTgt, kImRot, kRedSum, kOutStore, kF32>(A, st, segs_only);
    case 2:  // no_rows
      return launch<32, kFixed, kAmpFull, kImRot, kRedSum, kOutStore, kF32>(A, st, segs_only);
    case 3:  // no_env
      return launch<32, kRecur, kAmpNone, kImRot, kRedSum, kOutStore, kF32>(A, st, segs_only);
    case 4:  // no_reduce
      return launch<32, kRecur, kAmpFull, kImRot, kRedLane0, kOutStore, kF32>(A, st, segs_only);
    case 5:  // base
      return launch<32, kBase, kAmpFull, kImRot, kRedSum, kOutStore, kF32>(A, st, segs_only);
    case 6:  // recur
      return launch<32, kRecur2, kAmpFull, kImRot, kRedSum, kOutStore, kF32>(A, st, segs_only);
    case 7:  // loads
      return launch<32, kLoads, kAmpFull, kImRot, kRedSum, kOutStore, kF32>(A, st, segs_only);
    case 8:  // sub64
      return launch<64, kRecur, kAmpFull, kImRot, kRedSum, kOutStore, kF32>(A, st, segs_only);
    case 9:  // bf16_vpu
      return launch<32, kRecur, kAmpFull, kImRot, kRedSum, kOutStore, kBf16>(A, st, segs_only);
    case 10:  // const_rows
      return launch<32, kConst, kAmpFull, kImRot, kRedSum, kOutStore, kF32>(A, st, segs_only);
    case 11:  // noim
      return launch<32, kRecur, kAmpFull, kImZr, kRedSum, kOutStore, kF32>(A, st, segs_only);
    case 12:  // noout
      return launch<32, kRecur, kAmpFull, kImRot, kRedSum, kOutDrop, kF32>(A, st, segs_only);
    case 13:  // defmix
      return launch<32, kRecur, kAmpFull, kImRot, kRedDefer, kOutStore, kF32>(A, st, segs_only);
    case 14:  // defmix64
      return launch<64, kRecur, kAmpFull, kImRot, kRedDefer, kOutStore, kF32>(A, st, segs_only);
    case 15:  // scan
      return launch<32, kScan, kAmpFull, kImRot, kRedSum, kOutStore, kF32>(A, st, segs_only);
    case 16:  // scan64
      return launch<64, kScan, kAmpFull, kImRot, kRedSum, kOutStore, kF32>(A, st, segs_only);
    case 17:  // dot32
      return launch<32, kDot32, kAmpFull, kImRot, kRedSum, kOutStore, kF32>(A, st, segs_only);
    case 18:  // dot4
      return launch<32, kDot4, kAmpFull, kImRot, kRedSum, kOutStore, kF32>(A, st, segs_only);
    case 19:  // onehot_sub
      return launch<32, kMmaSub, kAmpFull, kImRot, kRedSum, kOutStore, kF32>(A, st, segs_only);
    case 20:  // onehot_all
      return launch<32, kMmaAll, kAmpFull, kImRot, kRedSum, kOutStore, kF32>(A, st, segs_only);
    case 21:  // bf16_mxu
      return launch<32, kRecur, kAmpFull, kImRot, kRedMma, kOutStore, kBf16>(A, st, segs_only);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One steady block of variant `variant` (the order of VARIANTS in
// oscen_tpu_torch/ops/cuda/kabl.py, pinned by its tests).  Planes [32, V]
// row-major, step and step_out [V], tbl [4B, 72] bf16 (the one-hot
// variants) or null.  With OUT store y is the [B] mix and part ([blocks +
// groups, B]) and cnt ([1 + groups] zeroed counters, left zeroed; groups =
// ceil(blocks / 16), blocks = ceil(V / warps), 2 warps per block in kernel
// A, 8 in kernel B; every time segment counts in its own field of them)
// are given and keep is null; with OUT drop, part and cnt are null and
// keep is [32, V].  U: the body length (64 or 128); cur_in: store the input
// cur as cur_out (kabl6 v5) instead of the final target.  Each voice runs
// in oscen_kabl_segments(variant, V, B, U) time segments.
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
               B, U, cur_in, 1};
  return dispatch(A, variant, (cudaStream_t)stream, nullptr);
}

// The time segments per voice oscen_kabl runs variant `variant` in at V
// voices, B ticks and body length U; a negative CUDA error code for a
// shape it refuses.
int oscen_kabl_segments(int variant, int V, int B, int U) {
  if (V < 1 || B < 32 || U < 32) return -(int)cudaErrorInvalidValue;
  Args A{};
  A.V = V;
  A.B = B;
  A.U = U;
  int segs = 0;
  const int rc = dispatch(A, variant, nullptr, &segs);
  return rc ? -rc : segs;
}

const char* oscen_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
