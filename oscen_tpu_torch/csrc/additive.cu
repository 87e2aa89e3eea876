// Fused electric-piano additive voice for Hopper (sm_90a).
//
// Replaces the TPU kernel oscen_tpu/ops/pallas/additive.py::
// _additive_voice_block, bodies _kernel_v4 (closed-form subgroups, the
// default) and _kernel_parity (exact per-sample op order): one steady block
// of AmplitudeSource -> OscillatorBank for every voice, optionally with the
// graph's FanIn voice mix-down fused in (with_mix).
//
// Layout: one warp per voice, one lane per harmonic (H = 32 = the warp
// width).  The complex oscillator, the envelope and the step counter stay in
// registers for the whole block; no [B, V, H] product reaches device memory.
// The per-voice row math of v4 (wrap tick jw, envelope product p, r1, r2) is
// computed redundantly in every lane of the warp.
//
// What bounds it on the card: each voice is a serial chain per sample (the
// envelope recurrence and the complex rotation) plus a 32-lane harmonic sum,
// and the flagship has only V = 256 voices, i.e. 256 warps for 132 SMs.  The
// kernel reads seven [H, V] planes once and writes [B, V] (or [B] per block
// with the mix), so it is bound by instruction latency, not by bytes.  The
// design answers with:
//  - the harmonic sums as a warp reduce-scatter over N = min(32, SUB)
//    samples at once: N - 1 + log2(32 / N) shuffles per N samples instead of
//    5 per sample, and lane L ends up holding the sum of sample L, so each
//    lane stores one value;
//  - the v4 m^j tables (j = 1..SUB, 128 floats per lane at SUB = 64)
//    replaced by a running product per lane that restarts every subgroup; it
//    is the recurrence the tables were built with, so the values are the
//    same and no table occupies registers;
//  - the mix-down summed across the block's warps through shared memory in a
//    fixed order, so the result is deterministic; per-block partial mixes
//    are summed after the kernel, as the TPU version sums its voice tiles.
//
// Numerics: the library is built with --fmad=false, so every product and sum
// rounds as the separate elementwise ops of the plain PyTorch version do.
// The state planes then match that version bit for bit and only the harmonic
// and voice sums differ, in their order.  Denormals are kept (no -ftz), as in
// PyTorch; the TPU flushes them, a difference far below the tolerances.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 32;

// Sum vals[0..N) over the 32 lanes.  Afterwards lane L holds the sum of
// sample L % N.  Stage c -> c/2: the lanes whose bit c/2 is set keep the
// upper half of the samples and receive it from their partner.
template <int N>
__device__ __forceinline__ float reduce_scatter(float (&vals)[N], int lane) {
#pragma unroll
  for (int c = N; c > 1; c /= 2) {
    const int half = c / 2;
    const bool upper = (lane & half) != 0;
#pragma unroll
    for (int k = 0; k < half; ++k) {
      const float send = upper ? vals[k] : vals[k + half];
      const float keep = upper ? vals[k + half] : vals[k];
      vals[k] = keep + __shfl_xor_sync(kFull, send, half);
    }
  }
  float s = vals[0];
#pragma unroll
  for (int o = N; o < 32; o *= 2) s += __shfl_xor_sync(kFull, s, o);
  return s;
}

// Store the N per-sample sums of one chunk starting at sample t0.  Without
// the mix, y is [B, V]; with it, y is [gridDim.x, B] partial mixes summed
// over this block's warps in warp order.
template <int N>
__device__ __forceinline__ void store_chunk(float ysum, int t0, int lane,
                                            int warp, int nw, int v, int V,
                                            int B, bool live, int with_mix,
                                            float* __restrict__ y,
                                            float (*red)[33]) {
  if (!with_mix) {
    if (live && lane < N) y[(size_t)(t0 + lane) * V + v] = ysum;
    return;
  }
  if (lane < N) red[warp][lane] = ysum;
  __syncthreads();
  if (threadIdx.x < N) {
    float acc = 0.f;
    for (int w = 0; w < nw; ++w) acc += red[w][threadIdx.x];
    y[(size_t)blockIdx.x * B + t0 + threadIdx.x] = acc;
  }
  __syncthreads();
}

struct Planes {
  const float* osc_re;
  const float* osc_im;
  const float* mul_re;
  const float* mul_im;
  const float* cur;
  const float* tgt;
  const float* mult;
  const float* step;
  float* y;
  float* osc_re_out;
  float* osc_im_out;
  float* cur_out;
  float* tgt_out;
  float* step_out;
};

// _kernel_v4: closed form over subgroups of SUB ticks (at most one envelope
// cycle wrap per subgroup; the cycle is 65 ticks).
template <int SUB>
__global__ void additive_v4_kernel(Planes P, int V, int B, int with_mix) {
  constexpr int N = SUB < 32 ? SUB : 32;
  __shared__ float red[kMaxWarps][33];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int v = blockIdx.x * nw + warp;
  const bool live = v < V;
  const int at = lane * V + v;

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

  for (int t0 = 0; t0 < B; t0 += SUB) {
    const float tgtm = tgt * mult;  // next cycle's target, if a wrap occurs
    const float G1 = tgtm - tgt;
    const bool at0 = s == 0.f;
    const float jw = at0 ? 0.f : 65.f - s;  // wrap tick (may be >= SUB)
    const float basef = s * (-1.f / 64.f);
    const float addf = at0 ? 0.f : 65.f / 64.f;
    float wr = mr, wi = mi;  // m^(j+1)
#pragma unroll
    for (int c = 0; c < SUB / N; ++c) {
      float vals[N];
#pragma unroll
      for (int jj = 0; jj < N; ++jj) {
        const int j = c * N + jj;
        const bool wfb = jw <= (float)j;
        const float cjb = basef + (63.f - (float)j) * (1.f / 64.f);
        const float f = cjb + (wfb ? addf : 0.f);
        p = (jw == (float)j) ? C : p * f;
        const float r1 = wfb ? 0.f : p;
        const float r2 = wfb ? 1.f - p : 0.f;
        const float amp = r2 * G1 + (r1 * D + tgt);
        const float im = zr * (wi * 3.f) + zi * (wr * 3.f);
        vals[jj] = im * amp;
        last_amp = amp;
        const float pr = wr, pi = wi;
        wr = pr * mr - pi * mi;
        wi = pr * mi + pi * mr;
      }
      const float ysum = reduce_scatter<N>(vals, lane);
      store_chunk<N>(ysum, t0 + c * N, lane, warp, nw, v, V, B, live,
                     with_mix, P.y, red);
    }
    const float nzr = zr * msr - zi * msi;
    const float nzi = zr * msi + zi * msr;
    zr = nzr;
    zi = nzi;
    const bool w_last = jw <= (float)(SUB - 1);
    tgt = w_last ? tgtm : tgt;
    D = w_last ? -G1 : D;
    // the step counter cycles 0..64 and SUB <= 64: one subtract is a mod
    const float t = s + (float)SUB;
    s = t >= 65.f ? t - 65.f : t;
  }

  if (live) {
    P.osc_re_out[at] = zr;
    P.osc_im_out[at] = zi;
    P.cur_out[at] = last_amp;
    P.tgt_out[at] = tgt;
    if (lane == 0) P.step_out[v] = s;
  }
}

// _kernel_parity: per sample, the envelope tick (target refresh at step 0,
// linear blend, step advance) and then the rotation, in the reference's op
// order.  N samples are summed per reduce-scatter.
template <int N>
__global__ void additive_parity_kernel(Planes P, int V, int B,
                                       int with_mix) {
  __shared__ float red[kMaxWarps][33];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int v = blockIdx.x * nw + warp;
  const bool live = v < V;
  const int at = lane * V + v;

  float zr = live ? P.osc_re[at] : 0.f;
  float zi = live ? P.osc_im[at] : 0.f;
  const float mr = live ? P.mul_re[at] : 0.f;
  const float mi = live ? P.mul_im[at] : 0.f;
  float cur = live ? P.cur[at] : 0.f;
  float tgt = live ? P.tgt[at] : 0.f;
  const float mult = live ? P.mult[at] : 0.f;
  float s = live ? P.step[v] : 0.f;

  for (int t0 = 0; t0 < B; t0 += N) {
    float vals[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      tgt = (s == 0.f) ? cur * mult : tgt;
      const bool interp = s < 64.f;
      const float tau = (s + 1.f) / 64.f;
      const float cur_i = cur * (1.f - tau) + tgt * tau;
      cur = interp ? cur_i : tgt;
      s = interp ? s + 1.f : 0.f;
      const float nre = zr * mr - zi * mi;
      const float nim = zr * mi + zi * mr;
      zr = nre;
      zi = nim;
      vals[k] = nim * cur;
    }
    const float ysum = reduce_scatter<N>(vals, lane) * 3.f;
    store_chunk<N>(ysum, t0, lane, warp, nw, v, V, B, live, with_mix, P.y,
                   red);
  }

  if (live) {
    P.osc_re_out[at] = zr;
    P.osc_im_out[at] = zi;
    P.cur_out[at] = cur;
    P.tgt_out[at] = tgt;
    if (lane == 0) P.step_out[v] = s;
  }
}

Planes make_planes(const float* osc_re, const float* osc_im,
                   const float* mul_re, const float* mul_im, const float* cur,
                   const float* tgt, const float* mult, const float* step,
                   float* y, float* osc_re_out, float* osc_im_out,
                   float* cur_out, float* tgt_out, float* step_out) {
  return Planes{osc_re, osc_im, mul_re,     mul_im,     cur,
                tgt,    mult,   step,       y,          osc_re_out,
                osc_im_out,     cur_out,    tgt_out,    step_out};
}

}  // namespace

extern "C" {

// One steady block of the v4 kernel.  Planes are [32, V] row-major, step and
// step_out [V]; y is [B, V], or [ceil(V / warps_per_block), B] partial mixes
// when with_mix.  sub is the subgroup length (8, 16, 32 or 64; divides B).
int oscen_additive_v4(const float* osc_re, const float* osc_im,
                      const float* mul_re, const float* mul_im,
                      const float* cur, const float* tgt, const float* mult,
                      const float* step, float* y, float* osc_re_out,
                      float* osc_im_out, float* cur_out, float* tgt_out,
                      float* step_out, int V, int B, int sub, int with_mix,
                      int warps_per_block, void* stream) {
  if (warps_per_block < 1 || warps_per_block > kMaxWarps)
    return (int)cudaErrorInvalidValue;
  const Planes P = make_planes(osc_re, osc_im, mul_re, mul_im, cur, tgt,
                               mult, step, y, osc_re_out, osc_im_out,
                               cur_out, tgt_out, step_out);
  const dim3 block(32 * warps_per_block);
  const dim3 grid((V + warps_per_block - 1) / warps_per_block);
  cudaStream_t st = (cudaStream_t)stream;
  switch (sub) {
    case 8: additive_v4_kernel<8><<<grid, block, 0, st>>>(P, V, B, with_mix);
      break;
    case 16: additive_v4_kernel<16><<<grid, block, 0, st>>>(P, V, B, with_mix);
      break;
    case 32: additive_v4_kernel<32><<<grid, block, 0, st>>>(P, V, B, with_mix);
      break;
    case 64: additive_v4_kernel<64><<<grid, block, 0, st>>>(P, V, B, with_mix);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// One steady block of the exact-op-order kernel; chunk (8, 16 or 32, divides
// B) is the number of samples per harmonic reduce-scatter.  Layout as above.
int oscen_additive_parity(const float* osc_re, const float* osc_im,
                          const float* mul_re, const float* mul_im,
                          const float* cur, const float* tgt,
                          const float* mult, const float* step, float* y,
                          float* osc_re_out, float* osc_im_out,
                          float* cur_out, float* tgt_out, float* step_out,
                          int V, int B, int chunk, int with_mix,
                          int warps_per_block, void* stream) {
  if (warps_per_block < 1 || warps_per_block > kMaxWarps)
    return (int)cudaErrorInvalidValue;
  const Planes P = make_planes(osc_re, osc_im, mul_re, mul_im, cur, tgt,
                               mult, step, y, osc_re_out, osc_im_out,
                               cur_out, tgt_out, step_out);
  const dim3 block(32 * warps_per_block);
  const dim3 grid((V + warps_per_block - 1) / warps_per_block);
  cudaStream_t st = (cudaStream_t)stream;
  switch (chunk) {
    case 8:
      additive_parity_kernel<8><<<grid, block, 0, st>>>(P, V, B, with_mix);
      break;
    case 16:
      additive_parity_kernel<16><<<grid, block, 0, st>>>(P, V, B, with_mix);
      break;
    case 32:
      additive_parity_kernel<32><<<grid, block, 0, st>>>(P, V, B, with_mix);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* oscen_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
