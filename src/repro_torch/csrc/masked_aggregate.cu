// Mask-weighted aggregation of client updates (the server update, eq. 4),
// plain and with each client's uplink quantised.
//
// masked_aggregate_kernel replaces the Pallas TPU kernel
// masked_aggregate_tiled (_kernel) of
// src/repro/kernels/masked_aggregate/kernel.py, with a leading trajectory
// axis: out[t, d] = sum_i coef[t, i] * g[t, i, d] over g [T, N, D] and
// coef [T, N], one launch for every trajectory of a sweep (the reference
// vmaps its kernel instead).
//
// What bounds it on this card: device memory.  Each g value is read once
// and used for one multiply-add, so the kernel streams T*N*D*4 bytes
// (1.27 GB per round for the paper's CNN at T=16, N=100) at 0.5 flop a
// byte, far below the card's balance point.
//
// Design: one thread per output column (t, d); neighbouring threads read
// neighbouring d, so every client row is read in coalesced 128-byte lines.
// Each thread walks the clients i = 0..N-1 in order with a float32 register
// accumulator (unrolled so that several loads are in flight): no shared
// memory, no atomics, and the sum is the same from run to run.
//
// quantized_masked_aggregate_kernel replaces quantized_masked_aggregate_tiled
// (_quantized_kernel) of the same file: b-bit stochastic rounding of every
// client row fused into the same sum,
//   out[t, d] = sum_i coef[t, i] * clip(floor(g/s) + [u < g/s - floor(g/s)],
//                                       -L, L) * s
// with g = g[t, i, d], u = noise[t, i, d], s = scale[t, i] and
// L = levels[t, i].  The wrapper computes s (the row's max |g| over L) and L
// once, as the reference's ops.py does, since a column cannot see its row.
// What bounds it: device memory again.  g and the uniform noise are both
// read once, 2*T*N*D*4 bytes (2.87 GB per round for the paper's CNN at
// T=18, N=100), against about a dozen float32 operations per element.  The
// design is the plain kernel's: one thread per output column, coalesced
// row reads, clients in order into one register, the quotient g/s a true
// (correctly rounded) division.  The TPU version pads clients with noise 1,
// scale 1 and levels 1; here the bounds check replaces the padding.
// Left for later: drawing the noise inside the kernel from a counter-based
// generator (Philox) would halve the bytes read, but needs a plain version
// that reproduces the same stream; fusing the row-max pass that computes s
// would save the wrapper's extra read of g.
#include <cuda_runtime.h>

#include "solve_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void masked_aggregate_kernel(const float* __restrict__ g,
                                        const float* __restrict__ coef,
                                        float* __restrict__ out, int n,
                                        long long d) {
  const long long col = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (col >= d) return;
  const long long t = blockIdx.y;
  const float* gt = g + t * n * d + col;
  const float* ct = coef + t * n;
  float acc = 0.0f;
#pragma unroll 8
  for (int i = 0; i < n; ++i) acc += ct[i] * gt[i * d];
  out[t * d + col] = acc;
}

__global__ void quantized_masked_aggregate_kernel(
    const float* __restrict__ g, const float* __restrict__ coef,
    const float* __restrict__ noise, const float* __restrict__ scale,
    const float* __restrict__ levels, float* __restrict__ out, int n,
    long long d) {
  const long long col = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (col >= d) return;
  const long long t = blockIdx.y;
  const float* gt = g + t * n * d + col;
  const float* ut = noise + t * n * d + col;
  const float* ct = coef + t * n;
  const float* st = scale + t * n;
  const float* lt = levels + t * n;
  float acc = 0.0f;
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    const float s = st[i];
    const float lv = lt[i];
    const float x = gt[i * d] / s;
    const float low = floorf(x);
    float q = low + (ut[i * d] < x - low ? 1.0f : 0.0f);
    q = repro::nan_min(repro::nan_max(q, -lv), lv) * s;
    acc += ct[i] * q;
  }
  out[t * d + col] = acc;
}

}  // namespace

extern "C" int repro_masked_aggregate(const float* g, const float* coef,
                                      float* out, int t, int n, long long d,
                                      void* stream) {
  if (t > 0 && d > 0) {
    const dim3 grid((unsigned int)((d + kThreads - 1) / kThreads),
                    (unsigned int)t);
    masked_aggregate_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        g, coef, out, n, d);
  }
  return (int)cudaGetLastError();
}

extern "C" int repro_quantized_masked_aggregate(
    const float* g, const float* coef, const float* noise, const float* scale,
    const float* levels, float* out, int t, int n, long long d,
    void* stream) {
  if (t > 0 && d > 0) {
    const dim3 grid((unsigned int)((d + kThreads - 1) / kThreads),
                    (unsigned int)t);
    quantized_masked_aggregate_kernel<<<grid, kThreads, 0,
                                        (cudaStream_t)stream>>>(
        g, coef, noise, scale, levels, out, n, d);
  }
  return (int)cudaGetLastError();
}
