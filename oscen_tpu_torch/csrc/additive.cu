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
// Layout: one warp per voice, one lane per harmonic (H = 32 = the warp
// width).  The complex oscillator, the envelope and the step counter stay in
// registers for the whole block; no [B, V, H] product reaches device memory.
// The per-voice row math of v4 / v3 / v2 (wrap tick, envelope product p, the
// row coefficients) is computed redundantly in every lane of the warp.
//
// What bounds it on the card: each voice is a serial chain per sample (the
// envelope recurrence and the complex rotation) plus a 32-lane harmonic sum,
// and the flagship has only V = 256 voices, i.e. 256 warps for 132 SMs.  The
// kernel reads seven [H, V] planes once and writes [B, V] (or [B] with the
// mix), so it is bound by instruction latency, not by bytes.  The design
// answers with:
//  - the harmonic sums as a warp reduce-scatter over N = min(32, SUB)
//    samples at once: N - 1 + log2(32 / N) shuffles per N samples instead of
//    5 per sample, and lane L ends up holding the sum of sample L, so each
//    lane stores one value;
//  - the m^j tables (j = 1..SUB, 128 floats per lane at SUB = 64) replaced
//    by a running product per lane that restarts every subgroup; it is the
//    recurrence the tables were built with, so the values are the same and
//    no table occupies registers.  v3's and v2's per-tick rows are computed
//    inline in the same loop, in their order, instead of as a SUB-long
//    pre-pass array;
//  - the mix-down in a fixed order, inside the kernel: each block sums its
//    warps through shared memory and stores a partial row; the last block of
//    each group of kMixGroup blocks (a ticket from a device counter) sums its
//    group's rows in block order, and the last group finisher sums the group
//    rows in group order and writes the mix, or, with the epilogue, the two
//    tremolo channels (every block computes the pan factors of a share of
//    the ticks first; they depend on the tick alone).  The finishers keep
//    32 row loads in flight per thread.  No float atomics: the order, and so
//    the result, is the same in every run, and the fused and unfused pianos
//    sum alike.
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

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 32;
// blocks per first-level group of the fixed-order mix
constexpr int kMixGroup = 16;
// Tremolo: the tick count at which the anchored phase rebases (K_REBASE)
constexpr float kRebase = 1048576.0f;
// 2*pi rounded to float, as PyTorch multiplies a float32 tensor by it
constexpr float kTau = (float)(2.0 * 3.14159265358979323846);

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
  float* part;       // with the mix: [gridDim.x + groups + 1, B] scratch
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
// in warp order) goes to part[blockIdx.x].
template <int N>
__device__ __forceinline__ void store_chunk(float ysum, int t0, int lane,
                                            int warp, int nw, int v, int V,
                                            int B, bool live, int with_mix,
                                            const Planes& P,
                                            float (*red)[33]) {
  if (!with_mix) {
    if (live && lane < N) P.y[(size_t)(t0 + lane) * V + v] = ysum;
    return;
  }
  if (lane < N) red[warp][lane] = ysum;
  __syncthreads();
  if (threadIdx.x < N) {
    float acc = 0.f;
    for (int w = 0; w < nw; ++w) acc += red[w][threadIdx.x];
    P.part[(size_t)blockIdx.x * B + t0 + threadIdx.x] = acc;
  }
  __syncthreads();
}

// Sum n rows of B floats (row stride B) in row order, 4 samples per load,
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
// epilogue their two panned channels ([B, 2]).
__device__ __forceinline__ void store_mix(const Planes& P, const float* pan,
                                          int c, float4 m) {
  if (P.epi == nullptr) {
    reinterpret_cast<float4*>(P.y)[c] = m;
    return;
  }
  const float4 pn = __ldcg(reinterpret_cast<const float4*>(pan) + c);
  float4* out = reinterpret_cast<float4*>(P.y) + 2 * c;  // samples 4c..4c+3
  out[0] = make_float4(m.x * pn.x, m.x * (1.f - pn.x),
                       m.y * pn.y, m.y * (1.f - pn.y));
  out[1] = make_float4(m.z * pn.z, m.z * (1.f - pn.z),
                       m.w * pn.w, m.w * (1.f - pn.w));
}

// The fixed-order mix: every thread of every block calls this last, after
// its block's partial rows are stored.  With the epilogue, every block
// first computes the pan factors of a share of the ticks (they depend on
// the tick alone), and the last finisher applies them to the mix.
__device__ void finish_mix(const Planes& P, int B) {
  __shared__ int s_last;
  const int nb = gridDim.x;
  const int ng = (nb + kMixGroup - 1) / kMixGroup;
  const int g = blockIdx.x / kMixGroup;
  const int n = min(kMixGroup, nb - g * kMixGroup);
  float* pan = P.part + (size_t)(nb + ng) * B;
  if (P.epi != nullptr)
    for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < B;
         t += nb * blockDim.x)
      pan[t] = tremolo_pan(P.epi, t);
  // publish this block's rows, then take a ticket of its group
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(&P.cnt[1 + g], 1u) == (unsigned)(n - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the group's last block: its rows in block order -> group row
  const int cols = B / 4;
  const int step = 2 * blockDim.x;
  float4* grow = reinterpret_cast<float4*>(P.part + (size_t)(nb + g) * B);
  for (int c = threadIdx.x; c < cols; c += step) {
    const int c1 = c + blockDim.x < cols ? c + blockDim.x : -1;
    float4 a0, a1;
    sum_rows2(P.part + (size_t)g * kMixGroup * B, n, B, c, c1, a0, a1);
    grow[c] = a0;
    if (c1 >= 0) grow[c1] = a1;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    P.cnt[1 + g] = 0;  // ready for the next launch on this stream
    s_last = atomicAdd(&P.cnt[0], 1u) == (unsigned)(ng - 1);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last group finisher: the group rows in group order -> the mix
  const float* rows = P.part + (size_t)nb * B;
  for (int c = threadIdx.x; c < cols; c += step) {
    const int c1 = c + blockDim.x < cols ? c + blockDim.x : -1;
    float4 a0, a1;
    sum_rows2(rows, ng, B, c, c1, a0, a1);
    store_mix(P, pan, c, a0);
    if (c1 >= 0) store_mix(P, pan, c1, a1);
  }
  if (threadIdx.x == 0) P.cnt[0] = 0;
}

// The closed-form kernels over subgroups of SUB ticks (at most one envelope
// cycle wrap per subgroup; the cycle is 65 ticks).  VER selects the row
// math: 4 = _kernel_v4 (the wrap tick jw in closed form), 3 = _kernel_v3
// (P recurrence and the wrapped flag carried tick by tick, the same amp
// expression as v4), 2 = _kernel (per-tick selects of (tgt, D) against the
// next cycle's (tgt2, D2), amp = tgtE + DE * P).
template <int SUB, int VER>
__global__ void additive_closed_kernel(Planes P, int V, int B, int with_mix) {
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
    // next cycle's target, if a wrap occurs (v2 names it tgt2, D2 = -G1)
    const float tgtm = tgt * mult;
    const float G1 = tgtm - tgt;
    const float D2 = tgt - tgtm;
    const bool at0 = s == 0.f;
    const float jw = at0 ? 0.f : 65.f - s;  // v4: wrap tick (may be >= SUB)
    const float basef = s * (-1.f / 64.f);
    const float addf = at0 ? 0.f : 65.f / 64.f;
    bool wrapped = false;  // v3 / v2: a wrap seen in this subgroup so far
    float wr = mr, wi = mi;  // m^(j+1)
#pragma unroll
    for (int c = 0; c < SUB / N; ++c) {
      float vals[N];
#pragma unroll
      for (int jj = 0; jj < N; ++jj) {
        const int j = c * N + jj;
        float amp;
        if constexpr (VER == 4) {
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
            const float tgtE = wrapped ? tgtm : tgt;
            const float DE = wrapped ? D2 : D;
            amp = tgtE + DE * p;
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
      store_chunk<N>(ysum, t0 + c * N, lane, warp, nw, v, V, B, live,
                     with_mix, P, red);
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
    } else {
      tgt = wrapped ? tgtm : tgt;
      D = wrapped ? D2 : D;
    }
  }

  if (live) {
    P.osc_re_out[at] = zr;
    P.osc_im_out[at] = zi;
    P.cur_out[at] = last_amp;
    P.tgt_out[at] = tgt;
    if (lane == 0) P.step_out[v] = s;
  }
  if (with_mix) finish_mix(P, B);
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
    store_chunk<N>(ysum, t0, lane, warp, nw, v, V, B, live, with_mix, P,
                   red);
  }

  if (live) {
    P.osc_re_out[at] = zr;
    P.osc_im_out[at] = zi;
    P.cur_out[at] = cur;
    P.tgt_out[at] = tgt;
    if (lane == 0) P.step_out[v] = s;
  }
  if (with_mix) finish_mix(P, B);
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

template <int VER>
int launch_closed(const Planes& P, int V, int B, int sub, int with_mix,
                  int warps_per_block, void* stream) {
  const dim3 block(32 * warps_per_block);
  const dim3 grid((V + warps_per_block - 1) / warps_per_block);
  cudaStream_t st = (cudaStream_t)stream;
  switch (sub) {
    case 8:
      additive_closed_kernel<8, VER><<<grid, block, 0, st>>>(P, V, B,
                                                             with_mix);
      break;
    case 16:
      additive_closed_kernel<16, VER><<<grid, block, 0, st>>>(P, V, B,
                                                              with_mix);
      break;
    case 32:
      additive_closed_kernel<32, VER><<<grid, block, 0, st>>>(P, V, B,
                                                              with_mix);
      break;
    case 64:
      additive_closed_kernel<64, VER><<<grid, block, 0, st>>>(P, V, B,
                                                              with_mix);
      break;
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
// groups + 1, B] scratch (the block rows, the group rows, the pan factors)
// and cnt [1 + groups] zeroed counters (groups = ceil(blocks / 16)), which
// the launch leaves zeroed.  sub is the subgroup
// length (8, 16, 32 or 64; divides B).  The epilogue runs in the v4 body
// only.
#define OSCEN_ADDITIVE_ARGS                                                  \
  const float *osc_re, const float *osc_im, const float *mul_re,             \
      const float *mul_im, const float *cur, const float *tgt,               \
      const float *mult, const float *step, float *y, float *part,           \
      unsigned *cnt, const float *epi, float *osc_re_out, float *osc_im_out, \
      float *cur_out, float *tgt_out, float *step_out, int V, int B,         \
      int sub, int with_mix, int warps_per_block, void *stream
#define OSCEN_ADDITIVE_PLANES                                             \
  make_planes(osc_re, osc_im, mul_re, mul_im, cur, tgt, mult, step, y,    \
              part, cnt, epi, osc_re_out, osc_im_out, cur_out, tgt_out,   \
              step_out)

int oscen_additive_v4(OSCEN_ADDITIVE_ARGS) {
  if (warps_per_block < 1 || warps_per_block > kMaxWarps || B % 4)
    return (int)cudaErrorInvalidValue;
  return launch_closed<4>(OSCEN_ADDITIVE_PLANES, V, B, sub, with_mix,
                          warps_per_block, stream);
}

int oscen_additive_v3(OSCEN_ADDITIVE_ARGS) {
  if (warps_per_block < 1 || warps_per_block > kMaxWarps || B % 4 || epi)
    return (int)cudaErrorInvalidValue;
  return launch_closed<3>(OSCEN_ADDITIVE_PLANES, V, B, sub, with_mix,
                          warps_per_block, stream);
}

int oscen_additive_v2(OSCEN_ADDITIVE_ARGS) {
  if (warps_per_block < 1 || warps_per_block > kMaxWarps || B % 4 || epi)
    return (int)cudaErrorInvalidValue;
  return launch_closed<2>(OSCEN_ADDITIVE_PLANES, V, B, sub, with_mix,
                          warps_per_block, stream);
}

// The exact-op-order kernel; sub (8, 16 or 32, divides B) is the number of
// samples per harmonic reduce-scatter.  Layout as above; no epilogue.
int oscen_additive_parity(OSCEN_ADDITIVE_ARGS) {
  if (warps_per_block < 1 || warps_per_block > kMaxWarps || B % 4 || epi)
    return (int)cudaErrorInvalidValue;
  const Planes P = OSCEN_ADDITIVE_PLANES;
  const dim3 block(32 * warps_per_block);
  const dim3 grid((V + warps_per_block - 1) / warps_per_block);
  cudaStream_t st = (cudaStream_t)stream;
  switch (sub) {
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
