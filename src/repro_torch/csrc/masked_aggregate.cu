// Mask-weighted aggregation of client updates (the server update, eq. 4).
//
// Replaces the Pallas TPU kernel masked_aggregate_tiled (_kernel) of
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
#include <cuda_runtime.h>

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
