// Probes of K7's and K8's per-step time (tools/scanprobe.py): the bodies
// of csrc/iir.cu before their redesign, each with one cost taken out, and
// a latency probe of the dependent ops their chains are made of.  On no
// model's path.
//
// tpt_probe<XC, U>: K7's old body (loads inside the loop, #pragma unroll
// U); XC reads x once into a register instead of per step.
// lp18_probe<XC, TANH, DIV, U>: K8's old body; TANH 0 replaces the float64
// tanh by the identity, DIV 0 the IEEE division by a product with the
// hoisted reciprocal of the first row (rows only).
// lat_kernel: clock64() around 4096 dependent steps of each op kind.
//
// Built like the other sources (--fmad=false); variants by number, as
// tools/scanprobe.py names them.
#include <cuda_runtime.h>

namespace {

template <int XC, int U>
__global__ void __launch_bounds__(32)
tpt_probe(const float* __restrict__ x, const float* __restrict__ h,
          const float* __restrict__ g, const float* __restrict__ k,
          const float* __restrict__ z0_in, const float* __restrict__ z1_in,
          float* __restrict__ y, float* __restrict__ z0_out,
          float* __restrict__ z1_out, int V, int B, int hs, int gs, int ks) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  float z0 = z0_in[v];
  float z1 = z1_in[v];
  const float x0 = x[v];
#pragma unroll U
  for (int t = 0; t < B; ++t) {
    const size_t i = (size_t)t * V + v;
    const float xt = XC ? x0 : x[i];
    const float ht = h[(size_t)t * hs + v];
    const float gt = g[(size_t)t * gs + v];
    const float kt = k[(size_t)t * ks + v];
    const float high = (xt - z0 * kt - z1) * ht;
    const float band = high * gt + z0;
    const float low = band * gt + z1;
    z0 = high * gt + band;
    z1 = band * gt + low;
    y[i] = low;
  }
  z0_out[v] = z0;
  z1_out[v] = z1;
}

template <int XC, int TANH, int DIV, int U>
__global__ void __launch_bounds__(32)
lp18_probe(const float* __restrict__ x, const float* __restrict__ g,
           const float* __restrict__ h, const float* __restrict__ z_in,
           float* __restrict__ y, float* __restrict__ z_out, int V, int B,
           int gs, int hs) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  float z0 = z_in[v];
  float z1 = z_in[V + v];
  float z2 = z_in[2 * V + v];
  const float x0 = x[v];
  const float r0 = 1.0f / (1.0f + g[v]);
#pragma unroll U
  for (int t = 0; t < B; ++t) {
    const size_t i = (size_t)t * V + v;
    const float xt = XC ? x0 : x[i];
    const float gt = g[(size_t)t * gs + v];
    const float ht = h[(size_t)t * hs + v];
    const float a = xt - ht * z0 - z1 - z2;
    const float hp = DIV ? a / (1.0f + gt) : a * r0;
    const float bp1 = gt * hp + z0;
    z0 = TANH ? (float)tanh((double)bp1) : bp1;
    const float bp2 = gt * bp1 + z1;
    z1 = bp2;
    z2 = gt * bp2 + z2;
    y[i] = z2;
  }
  z_out[v] = z0;
  z_out[V + v] = z1;
  z_out[2 * V + v] = z2;
}

}  // namespace

extern "C" {

int probe_tpt(int variant, const float* x, const float* h, const float* g,
              const float* k, const float* z0, const float* z1, float* y,
              float* z0o, float* z1o, int V, int B, int hs, int gs, int ks,
              void* stream) {
  const dim3 grid((V + 31) / 32);
  cudaStream_t st = (cudaStream_t)stream;
#define L(XC, U) tpt_probe<XC, U><<<grid, 32, 0, st>>>(x, h, g, k, z0, z1, y, \
                                                       z0o, z1o, V, B, hs, gs, ks)
  switch (variant) {
    case 0: L(0, 4); break;
    case 1: L(1, 4); break;
    case 2: L(0, 16); break;
    case 3: L(0, 1); break;
    default: return 1;
  }
#undef L
  return (int)cudaGetLastError();
}

int probe_lp18(int variant, const float* x, const float* g, const float* h,
               const float* z, float* y, float* zo, int V, int B, int gs,
               int hs, void* stream) {
  const dim3 grid((V + 31) / 32);
  cudaStream_t st = (cudaStream_t)stream;
#define L(XC, T, D, U) lp18_probe<XC, T, D, U><<<grid, 32, 0, st>>>( \
    x, g, h, z, y, zo, V, B, gs, hs)
  switch (variant) {
    case 0: L(0, 1, 1, 4); break;   // (a) as is
    case 1: L(1, 1, 1, 4); break;   // (b) x from a register
    case 2: L(0, 0, 1, 4); break;   // (c) tanh -> identity
    case 3: L(0, 1, 0, 4); break;   // (d) division -> product
    case 4: L(1, 0, 0, 4); break;   // (b+c+d) the bare chain
    case 5: L(0, 1, 1, 16); break;  // unroll 16
    case 6: L(0, 0, 0, 4); break;   // (c+d) loads, no tanh, no division
    default: return 1;
  }
#undef L
  return (int)cudaGetLastError();
}

}  // extern "C"

// latency of dependent chains, cycles per op (clock64), one thread
__global__ void lat_kernel(float* out, long long* cyc, float seed, int n) {
  __shared__ int tbl[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) tbl[i] = (i * 7 + 1) & 255;
  __syncthreads();
  if (threadIdx.x) return;
  float f = seed; double d = seed; int j = (int)seed;
  long long t0 = clock64();
  for (int i = 0; i < n; ++i) f = f * 0.999f + 0.5f;          // FMUL+FADD (fmad off)
  long long t1 = clock64();
  for (int i = 0; i < n; ++i) d = __fma_rn(d, 0.999, 0.5);     // DFMA
  long long t2 = clock64();
  for (int i = 0; i < n; ++i) f = (float)((double)f + 1e-30);  // F2F, DADD, F2F
  long long t3 = clock64();
  for (int i = 0; i < n; ++i) j = tbl[j];                       // LDS
  long long t4 = clock64();
  for (int i = 0; i < n; ++i) d = __dmul_rn(d, 1.0000001);      // DMUL
  long long t5 = clock64();
  float q = f;
  for (int i = 0; i < n; ++i) q = 1.0f / (q + 1.5f);            // IEEE div
  long long t6 = clock64();
  out[0] = f + (float)d + j + q;
  cyc[0] = t1 - t0; cyc[1] = t2 - t1; cyc[2] = t3 - t2; cyc[3] = t4 - t3;
  cyc[4] = t5 - t4; cyc[5] = t6 - t5;
}

extern "C" int probe_lat(float* out, long long* cyc, int n) {
  lat_kernel<<<1, 32>>>(out, cyc, 1.25f, n);
  return (int)cudaGetLastError();
}
