// Harmonic-major ablation of the fused additive voice (K16, kabl5) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel of tools/kabl5.py:254 (make_hmaj :113), the
// variants hmaj_cp (rows by a log-step segmented cumprod in the kernel),
// hmaj_x (rows read from [B, V] inputs) and hmaj_t2 (two voice tiles).  The
// v3 body turned around: per subgroup of SUB = 32 ticks, a loop over the H =
// 32 harmonics accumulates [SUB, V] planes
//     acc += (zr_h * Mi_h,j + zi_h * Mr_h,j) * (r2_j * G1_h + (r1_j * D_h +
//            tgt_h))
// with the rotation tables Mi / Mr = 3 sin / 3 cos((j + 1) theta) read from
// device memory (ti3 / tr3 [H * SUB, V], 1 MB each at V = 256) instead of
// iterated, and the subgroup rotation m^SUB given as msr / msi [H, V].  The
// voices are mixed per tick; y is [B, 128 * TILES], each tile's mix stored
// across its 128 columns, as the tool stores it.
//
// Layout: a CUDA block is 32 voices x 32 ticks (1024 threads) over one
// time segment.  Thread (j, v) accumulates tick j of voice v over the
// harmonics; the same thread owns harmonic h = j of voice v's state
// (oscillator, target, D) in registers and publishes it to shared memory
// once per subgroup.  Warp w also computes voice w's rows for the
// subgroup, lane j tick j, by the segmented cumprod of kabl5.py:139-162 as
// a multiplicative shuffle scan (the tool's pltpu.roll, in its
// Hillis-Steele order; kabl_scan.cuh, which kabl.cu's scan rows share),
// and hands them to the accumulating threads through shared memory: the
// scan runs across the SUB ticks, the accumulation across the voices.
// hmaj_t2: the TPU's two-tile grid was there to overlap DMA with compute;
// on the card every block runs at once, so the analogue is two voice
// tiles, each with its own fixed-order mix and its own 128 output columns.
//
// What bounds it on the card: the tables are 2 MB read once per block of
// ticks (0.6 us at 3.35 TB/s) and the plane math ~8 float ops per tick,
// harmonic and voice (6 us of 67 TFLOP/s at B = 1024 would need every
// lane busy); the real limit is latency: each tick's accumulation a
// 32-long dependent chain, two __syncthreads per subgroup.  One block per
// 32 voices gave V = 256 8 blocks of 1024 threads, 8 of 132 SMs.  So the
// time axis is split into S segments of subgroups (hmaj_segments: 16,
// halved until S divides the B / SUB subgroups; 16 at B = 1024, 128
// blocks at V = 256), a block per (32 voices, segment).  A segment that
// starts at subgroup K rebuilds the state the one-block kernel holds
// there: each thread rotates its harmonic by msr / msi K times (the
// sequential recurrence) and steps its voice's (tgt, D) by the voice's
// per-subgroup wrap flag, walking the step per subgroup (scan_step); warp
// w replays its voice's rows' carry p (scan_replay_p: the scan from the
// last subgroup whose last tick wraps).  Every tick's harmonic loop and
// voice butterfly are the one-block kernel's, so y is too, bit for bit.
//
// The voice mix per tick: a warp butterfly over its 32 voices, the block
// rows summed in a fixed order per tile by K1's finish (additive_common.cuh:
// the last block of each group of 16 takes a ticket and sums its group, the
// last group finisher the group rows).  Each (tile, segment) counts its
// tickets in counter words of its own (S reaches 16, more fields than a
// word holds) and sums only its columns.  No float atomics.
//
// Numerics: --fmad=false; the state planes equal the plain PyTorch version
// (oscen_tpu_torch/ops/cuda/kabl.py::plain_hmaj) bit for bit, y differs by
// the order of the voice sum.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include "additive_common.cuh"
#include "kabl_scan.cuh"

namespace {

using oscen_additive::kFull;
using oscen_additive::kMixGroup;
constexpr int kH = 32;     // harmonics
constexpr int kSub = 32;   // ticks per subgroup
constexpr int kVoices = 32;  // voices per block
constexpr int kMaxSegments = 16;  // time segments per voice, at most

// Time segments per voice at B ticks: kMaxSegments, halved until they
// divide the B / kSub subgroups.
int hmaj_segments(int B) {
  int s = kMaxSegments;
  while (s > 1 && (B / kSub) % s) s /= 2;
  return s;
}

struct HArgs {
  const float* osc_re;
  const float* osc_im;
  const float* ti3;   // [H * SUB, V] 3 sin((j + 1) theta)
  const float* tr3;   // [H * SUB, V] 3 cos((j + 1) theta)
  const float* msr;   // [H, V] cos(SUB theta)
  const float* msi;   // [H, V] sin(SUB theta)
  const float* cur;
  const float* tgt;
  const float* mult;
  const float* step;  // [V]
  const float* r1x;   // [B, V] external rows (hmaj_x) or null
  const float* r2x;
  float* y;           // [B, 128 * tiles]
  float* part;        // per tile [blocks + groups, B]
  unsigned* cnt;      // per tile and segment [1 + groups]
  float* osc_re_out;
  float* osc_im_out;
  float* cur_out;
  float* tgt_out;
  float* step_out;
  int V, B, segs;
};

// The tile's fixed-order mix of one segment's ticks [T0, T1)
// (additive_common.cuh's finish, the tile's rows and the (tile, segment)'s
// tickets its own), each tick's mix written across the tile's 128 columns
// of y.
__device__ void finish_tile(const HArgs& A, int nb, int tile, int b, int seg,
                            int T0, int T1, int tiles) {
  const int B = A.B;
  const int ng = (nb + kMixGroup - 1) / kMixGroup;
  const int ld = 128 * tiles;
  float* y = A.y;
  oscen_additive::finish_rows(
      A.part + (size_t)tile * (nb + ng) * B,
      A.cnt + (size_t)(tile * A.segs + seg) * (1 + ng), nb, b, B, T0 / 4,
      T1 / 4, 1u, 0xffffffffu, [=](int c, float4 a) {
        const float m[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float4* row = reinterpret_cast<float4*>(
              y + (size_t)(4 * c + k) * ld + tile * 128);
          for (int i = 0; i < 32; ++i)
            row[i] = make_float4(m[k], m[k], m[k], m[k]);
        }
      });
}

template <int EXT_ROWS, int TILES>
__global__ void __launch_bounds__(kVoices * kSub)
kabl_hmaj_kernel(HArgs A) {
  __shared__ float zs_r[kH][kVoices], zs_i[kH][kVoices];
  __shared__ float zs_t[kH][kVoices], zs_d[kH][kVoices], zs_g[kH][kVoices];
  __shared__ float r1s[kSub][kVoices + 1], r2s[kSub][kVoices + 1];
  __shared__ int wls[kVoices];
  const int lane = threadIdx.x & 31;   // voice l of the block
  const int j = threadIdx.x >> 5;      // tick j, harmonic h = j
  const int V = A.V, B = A.B;
  // block = segment x (tile x voice block)
  const int nbt = V / kVoices;         // voice blocks over all tiles
  const int nb = nbt / TILES;          // voice blocks per tile
  const int vblk = blockIdx.x % nbt;
  const int seg = blockIdx.x / nbt;
  const int tile = vblk / nb, b = vblk % nb;
  const int len = B / A.segs;          // a multiple of kSub
  const int T0 = seg * len, T1 = T0 + len;
  const int v = vblk * kVoices + lane;
  const bool live = v < V;
  const int at = j * V + v;            // harmonic j of voice v

  // harmonic j of voice v
  float zr = live ? A.osc_re[at] : 0.f;
  float zi = live ? A.osc_im[at] : 0.f;
  const float msr = live ? A.msr[at] : 0.f;
  const float msi = live ? A.msi[at] : 0.f;
  const float cur0 = live ? A.cur[at] : 0.f;
  const float mult = live ? A.mult[at] : 0.f;
  const float s_v = live ? A.step[v] : 0.f;
  float tgt = (s_v == 0.f) ? cur0 : (live ? A.tgt[at] : 0.f);
  float D = cur0 - tgt;
  // warp j's voice (for the rows): voice w = j of the block
  const int vw = vblk * kVoices + j;
  float s = vw < V ? A.step[vw] : 0.f;
  float p = 1.f;
  const int K = T0 / kSub;
  if (K > 0) {
    // the state at subgroup K: harmonic j of voice v steps with its
    // voice's wrap flags, warp j's voice replays its step and carry
    float sv = s_v;
#pragma unroll 1
    for (int k = 0; k < K; ++k) {
      const float tgtm = tgt * mult;
      const float G1 = tgtm - tgt;
      const float nzr = zr * msr - zi * msi;
      const float nzi = zr * msi + zi * msr;
      zr = nzr;
      zi = nzi;
      const bool w = oscen_kscan::scan_step<kSub>(sv);
      tgt = w ? tgtm : tgt;
      D = w ? -G1 : D;
    }
    p = oscen_kscan::scan_replay_p<kSub>(K, s, lane);
#pragma unroll 1
    for (int k = 0; k < K; ++k) oscen_kscan::scan_step<kSub>(s);
  }

  for (int t0 = T0; t0 < T1; t0 += kSub) {
    const float tgtm = tgt * mult;
    const float G1 = tgtm - tgt;
    zs_r[j][lane] = zr;
    zs_i[j][lane] = zi;
    zs_t[j][lane] = tgt;
    zs_d[j][lane] = D;
    zs_g[j][lane] = G1;
    {
      // rows_for of voice j, lane = tick (kabl5.py:139-162)
      float r1[2], r2[2];
      p = oscen_kscan::scan_rows<kSub>(s, p, lane, r1, r2);
      if (!EXT_ROWS) {
        r1s[lane][j] = r1[0];
        r2s[lane][j] = r2[0];
      }
      const bool w_last = oscen_kscan::scan_step<kSub>(s);
      if (lane == 0) wls[j] = w_last;
    }
    __syncthreads();
    // tick j of voice lane: the harmonic loop
    float r1, r2;
    if (EXT_ROWS) {
      r1 = live ? A.r1x[(size_t)(t0 + j) * V + v] : 0.f;
      r2 = live ? A.r2x[(size_t)(t0 + j) * V + v] : 0.f;
    } else {
      r1 = r1s[j][lane];
      r2 = r2s[j][lane];
    }
    float acc = 0.f;
#pragma unroll 8
    for (int h = 0; h < kH; ++h) {
      const size_t row = (size_t)(h * kSub + j) * V + v;
      const float Mi = live ? __ldg(A.ti3 + row) : 0.f;
      const float Mr = live ? __ldg(A.tr3 + row) : 0.f;
      const float im = zs_r[h][lane] * Mi + zs_i[h][lane] * Mr;
      float amp = r1 * zs_d[h][lane] + zs_t[h][lane];
      amp = r2 * zs_g[h][lane] + amp;
      acc = acc + im * amp;
    }
#pragma unroll
    for (int o = 16; o >= 1; o /= 2) acc += __shfl_xor_sync(kFull, acc, o);
    if (lane == 0) {
      const int ng = (nb + kMixGroup - 1) / kMixGroup;
      A.part[((size_t)tile * (nb + ng) + b) * B + t0 + j] = acc;
    }
    __syncthreads();
    // harmonic j of voice lane: rotate, and move to the next cycle on a wrap
    const float nzr = zr * msr - zi * msi;
    const float nzi = zr * msi + zi * msr;
    zr = nzr;
    zi = nzi;
    const bool w = wls[lane] != 0;
    tgt = w ? tgtm : tgt;
    D = w ? -G1 : D;
  }
  if (seg == A.segs - 1) {
    if (live) {
      A.osc_re_out[at] = zr;
      A.osc_im_out[at] = zi;
      A.cur_out[at] = tgt;
      A.tgt_out[at] = tgt;
    }
    if (lane == 0 && vw < V) A.step_out[vw] = s;
  }
  finish_tile(A, nb, tile, b, seg, T0, T1, TILES);
}

}  // namespace

extern "C" {

// One steady block, harmonic-major.  osc_re, osc_im, msr, msi, cur, tgt,
// mult [32, V]; ti3, tr3 [32 * 32, V]; step and step_out [V]; r1x, r2x
// [B, V] with ext_rows, else null; y [B, 128 * tiles]; part: per tile
// [blocks + groups, B] (blocks = V / 32 / tiles, groups = ceil(blocks / 16))
// and cnt per tile and time segment [1 + groups] zeroed counters (tiles x
// oscen_kabl_hmaj_segments(B) x (1 + groups) words), left zeroed.  V a
// multiple of 32 * tiles, B of 32.
int oscen_kabl_hmaj(const float* osc_re, const float* osc_im,
                    const float* ti3, const float* tr3, const float* msr,
                    const float* msi, const float* cur, const float* tgt,
                    const float* mult, const float* step, const float* r1x,
                    const float* r2x, float* y, float* part, unsigned* cnt,
                    float* osc_re_out, float* osc_im_out, float* cur_out,
                    float* tgt_out, float* step_out, int ext_rows, int tiles,
                    int V, int B, void* stream) {
  if (V < 1 || tiles < 1 || V % (kVoices * tiles) || B < kSub || B % kSub ||
      (ext_rows && (r1x == nullptr || r2x == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int segs = hmaj_segments(B);
  const HArgs A{osc_re, osc_im, ti3, tr3, msr, msi, cur, tgt, mult, step,
                r1x, r2x, y, part, cnt, osc_re_out, osc_im_out, cur_out,
                tgt_out, step_out, V, B, segs};
  const dim3 grid(V / kVoices * segs), block(kVoices * kSub);
  cudaStream_t st = (cudaStream_t)stream;
  if (ext_rows && tiles == 1)
    kabl_hmaj_kernel<1, 1><<<grid, block, 0, st>>>(A);
  else if (!ext_rows && tiles == 1)
    kabl_hmaj_kernel<0, 1><<<grid, block, 0, st>>>(A);
  else if (!ext_rows && tiles == 2)
    kabl_hmaj_kernel<0, 2><<<grid, block, 0, st>>>(A);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The time segments per voice oscen_kabl_hmaj runs at B ticks.
int oscen_kabl_hmaj_segments(int B) {
  if (B < kSub || B % kSub) return -(int)cudaErrorInvalidValue;
  return hmaj_segments(B);
}

const char* oscen_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
