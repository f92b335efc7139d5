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
// L = levels[t, i].  row_scale_kernel computes s = max(max_d |g|, 1e-12) / L
// in front of it (the reference computes it with jnp.max before its kernel,
// src/repro/kernels/masked_aggregate/ops.py:62), since a column cannot see
// its row.
//
// What the function needs: one read of every row, for its max |g| (a row
// whose coefficient is 0 still sets the sum to NaN when it holds a NaN or
// an inf, as 0 * Q(g) is NaN there), and then g and the noise again only for
// the rows with a nonzero coefficient.  What bounds both kernels on this
// card: device memory.  The scale pass streams T*N*D*4 bytes with one max
// per element; the sum about a dozen float32 operations per element read.
//
// The scale pass: the max of non-negative floats is the max of their bit
// patterns as unsigned integers, and that order puts every NaN (sign
// cleared) above inf above every finite value, so an integer max over
// |g|'s bits is torch.amax's NaN-propagating max, in any order of
// combination.  One block per row (1,800 rows at T = 18; at T = 1 its 100
// rows leave a quarter of the 132 SMs idle, but splitting rows over blocks and
// combining the partial maxima bought under 0.01 ms a round there and
// nothing at T = 18, so the pass is one launch of one kernel).  16-byte
// loads after a scalar head up to the first 16-byte boundary, four in
// flight per thread.
//
// The sum: row i of trajectory t adds exactly +-0 to every column (and so
// is skipped, with no load of g or noise) when
//   coef[t, i] == 0,  scale[t, i] > 0  and  |levels[t, i] * scale[t, i]| < inf.
// Contract: this is exact whenever scale is the row's max(max|g|, 1e-12) / L
// as row_scale_kernel (or the wrapper's plain row_scale) computes it.  Then
// a finite positive scale means every g of the row is finite, so g/s is
// never NaN, the clipped q lies in [-L, L] and q*s is finite, and
// coef * q * s is +-0; the float32 accumulator, which starts at +0, is
// unchanged by adding +-0.  A NaN or inf anywhere in the row makes its scale
// NaN or inf, and the row is read, as are rows at a width so large that the
// scale underflows to 0.  Every thread of a block shares t, so each block
// first compacts the list of rows it must read (in client order, through
// shared memory) and the branch costs no divergence.  Each thread owns 4
// adjacent columns (16-byte loads of g and noise) when D % 4 == 0 and the
// pointers are 16-byte aligned, else one column; it loads four live rows
// before it adds any, for bytes in flight.  What keeps it bit-equal to the
// plain version: the clients in order into one float32 register per column,
// the quotient g/s a true (correctly rounded) division, clip as
// nan_min(nan_max(q, -L), L), and no FMA contraction (--fmad=false).  The
// TPU version pads clients with noise 1, scale 1 and levels 1; here the
// bounds check replaces the padding.
// Left for later: drawing the noise inside the kernel from a counter-based
// generator (Philox) would remove its bytes, but needs a plain version that
// reproduces the same stream.
#include <cuda_runtime.h>

#include <cstdint>

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

// |x| as the bits of a non-negative float: ordered as unsigned integers,
// NaN above inf above every finite value
__device__ __forceinline__ unsigned int abs_bits(float x) {
  return __float_as_uint(x) & 0x7fffffffu;
}

__device__ __forceinline__ unsigned int max4(float4 x) {
  return max(max(abs_bits(x.x), abs_bits(x.y)),
             max(abs_bits(x.z), abs_bits(x.w)));
}

// max(m, 1e-12) / L, as torch.clamp(min=1e-12) then a true division
__device__ __forceinline__ float finish_scale(unsigned int m, float levels) {
  return repro::nan_max(__uint_as_float(m), 1e-12f) / levels;
}

// One block per row: the max |g| bits over the row, then the scale.
__global__ void __launch_bounds__(kThreads) row_scale_kernel(
    const float* __restrict__ g, const float* __restrict__ levels,
    float* __restrict__ scale, long long d) {
  __shared__ unsigned int warp_max[kThreads / 32];
  const long long row = blockIdx.x;
  const float* p = g + row * d;
  // floats before the first 16-byte boundary (p is 4-byte aligned)
  const long long head = min(
      (long long)((16u - ((unsigned int)(uintptr_t)p & 15u)) & 15u) / 4, d);
  unsigned int m = threadIdx.x < head ? abs_bits(p[threadIdx.x]) : 0u;
  const float4* v = reinterpret_cast<const float4*>(p + head);
  const long long nvec = (d - head) / 4;
  long long k = threadIdx.x;
  for (; k + 3 * kThreads < nvec; k += 4 * kThreads) {
    const float4 a = __ldg(v + k), b = __ldg(v + k + kThreads),
                 c = __ldg(v + k + 2 * kThreads),
                 e = __ldg(v + k + 3 * kThreads);
    m = max(m, max(max(max4(a), max4(b)), max(max4(c), max4(e))));
  }
  for (; k < nvec; k += kThreads) m = max(m, max4(__ldg(v + k)));
  for (long long j = head + 4 * nvec + threadIdx.x; j < d; j += kThreads)
    m = max(m, abs_bits(p[j]));
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) m = max(m, warp_max[w]);
    scale[row] = finish_scale(m, levels[row]);
  }
}

// True when the row adds exactly +-0 to every column (the header's contract).
__device__ __forceinline__ bool row_adds_zero(float c, float s, float lv) {
  return c == 0.0f && s > 0.0f && fabsf(lv * s) < INFINITY;
}

__device__ __forceinline__ float quantized_term(float g, float u, float s,
                                                float lv, float c) {
  const float x = g / s;
  const float low = floorf(x);
  float q = low + (u < x - low ? 1.0f : 0.0f);
  q = repro::nan_min(repro::nan_max(q, -lv), lv) * s;
  return c * q;
}

template <int V>
__device__ __forceinline__ void load_cols(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  } else {
    x[0] = __ldg(p);
  }
}

constexpr int kRowsInFlight = 4;

// V adjacent columns per thread; blockIdx.y is the trajectory.
template <int V>
__global__ void __launch_bounds__(kThreads) quantized_masked_aggregate_kernel(
    const float* __restrict__ g, const float* __restrict__ coef,
    const float* __restrict__ noise, const float* __restrict__ scale,
    const float* __restrict__ levels, float* __restrict__ out, int n,
    long long d) {
  __shared__ int live_row[kThreads];
  __shared__ float live_c[kThreads], live_s[kThreads], live_l[kThreads];
  __shared__ int warp_live[kThreads / 32];
  const long long col = (blockIdx.x * (long long)kThreads + threadIdx.x) * V;
  const bool active = col < d;            // V = 4 only when D % 4 == 0
  const long long t = blockIdx.y;
  const float* gt = g + t * n * d + col;
  const float* ut = noise + t * n * d + col;
  const float* ct = coef + t * n;
  const float* st = scale + t * n;
  const float* lt = levels + t * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0f;
  for (int base = 0; base < n; base += kThreads) {
    // this chunk's rows that the sum needs, compacted in client order
    const int i = base + threadIdx.x;
    float c = 0.0f, s = 0.0f, lv = 0.0f;
    bool live = false;
    if (i < n) {
      c = ct[i], s = st[i], lv = lt[i];
      live = !row_adds_zero(c, s, lv);
    }
    const unsigned int ballot = __ballot_sync(0xffffffffu, live);
    if (lane == 0) warp_live[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      offset += w < warp ? warp_live[w] : 0;
      total += warp_live[w];
    }
    if (live) {
      const int slot = offset + __popc(ballot & ((1u << lane) - 1u));
      live_row[slot] = i, live_c[slot] = c, live_s[slot] = s, live_l[slot] = lv;
    }
    __syncthreads();
    if (active) {
      int j = 0;
      for (; j + kRowsInFlight <= total; j += kRowsInFlight) {
        float gv[kRowsInFlight][V], uv[kRowsInFlight][V];
#pragma unroll
        for (int r = 0; r < kRowsInFlight; ++r) {
          const long long off = live_row[j + r] * d;
          load_cols<V>(gt + off, gv[r]);
          load_cols<V>(ut + off, uv[r]);
        }
#pragma unroll
        for (int r = 0; r < kRowsInFlight; ++r)
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[v] += quantized_term(gv[r][v], uv[r][v], live_s[j + r],
                                     live_l[j + r], live_c[j + r]);
      }
      for (; j < total; ++j) {
        float gv[V], uv[V];
        const long long off = live_row[j] * d;
        load_cols<V>(gt + off, gv);
        load_cols<V>(ut + off, uv);
#pragma unroll
        for (int v = 0; v < V; ++v)
          acc[v] += quantized_term(gv[v], uv[v], live_s[j], live_l[j],
                                   live_c[j]);
      }
    }
    __syncthreads();                      // the next chunk rewrites the list
  }
  if (!active) return;
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(out + t * d + col) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    out[t * d + col] = acc[0];
  }
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

extern "C" int repro_row_scale(const float* g, const float* levels,
                               float* scale, long long rows, long long d,
                               void* stream) {
  if (rows > 0 && d > 0)
    row_scale_kernel<<<(unsigned int)rows, kThreads, 0, (cudaStream_t)stream>>>(
        g, levels, scale, d);
  return (int)cudaGetLastError();
}

extern "C" int repro_quantized_masked_aggregate(
    const float* g, const float* coef, const float* noise, const float* scale,
    const float* levels, float* out, int t, int n, long long d,
    void* stream) {
  if (t > 0 && d > 0) {
    const bool vec = d % 4 == 0 &&
                     (((uintptr_t)g | (uintptr_t)noise | (uintptr_t)out) & 15u) == 0;
    const long long cols = vec ? d / 4 : d;
    const dim3 grid((unsigned int)((cols + kThreads - 1) / kThreads),
                    (unsigned int)t);
    if (vec)
      quantized_masked_aggregate_kernel<4><<<grid, kThreads, 0,
                                             (cudaStream_t)stream>>>(
          g, coef, noise, scale, levels, out, n, d);
    else
      quantized_masked_aggregate_kernel<1><<<grid, kThreads, 0,
                                             (cudaStream_t)stream>>>(
          g, coef, noise, scale, levels, out, n, d);
  }
  return (int)cudaGetLastError();
}
