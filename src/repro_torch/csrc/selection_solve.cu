// Per-element solves of problem (7) on Hopper: two elementwise kernels.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/selection_solve/
// kernel.py:
//   * fused_solve_kernel      <- fused_solve_tiled (_fused_kernel,
//                                _fused_solve_tile): Algorithm 2's fused
//                                fixed point, n_iters steps per element;
//   * selection_solve_kernel  <- selection_solve_tiled (_kernel,
//                                _solve_tile, _feasible): the exact optimum,
//                                feasibility at a = 1, then 60 bisection
//                                steps.
//
// What bounds them on this card: arithmetic.  Each element reads 16 bytes
// and writes 8, then runs 50 steps (or 61 feasibility tests) of float32
// divisions, logf and expm1f: a few thousand instructions per 24 bytes, so
// the memory system is idle and the special-function and FP32 pipes are
// the limit.  At the slice's shape (100 elements) a launch is one block and
// the time is the launch latency.
//
// Design: one thread per element over a flat [E] array with a bounds check
// (the TPU version pads to 128 lanes with 1.0 instead); every iterate stays
// in registers and nothing but the two outputs goes back to memory.  The
// kernels launch on the caller's stream, allocate nothing, and return
// cudaGetLastError() to the Python wrapper.
#include "solve_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBisect = 60;

__global__ void fused_solve_kernel(const float* __restrict__ pg,
                                   const float* __restrict__ bw,
                                   const float* __restrict__ emax,
                                   const float* __restrict__ ec,
                                   float* __restrict__ a_out,
                                   float* __restrict__ p_out, long long n,
                                   repro::SolveScalars c, int n_iters) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float g = pg[i], b = bw[i], e = emax[i], cc = ec[i];
  float a = repro::fused_init(g, b, e, cc, c);
  float p = c.p_max;
  // the first step is iteration 1, as in fused_fixed_point: n_iters steps
  repro::fused_step(a, p, g, b, e, cc, c);
  for (int it = 1; it < n_iters; ++it) repro::fused_step(a, p, g, b, e, cc, c);
  a_out[i] = a;
  p_out[i] = p;
}

__global__ void selection_solve_kernel(const float* __restrict__ pg,
                                       const float* __restrict__ bw,
                                       const float* __restrict__ emax,
                                       const float* __restrict__ ec,
                                       float* __restrict__ a_out,
                                       float* __restrict__ p_out, long long n,
                                       repro::SolveScalars c) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float g = pg[i], b = bw[i], e = emax[i], cc = ec[i];
  const bool feas1 = repro::bisection_feasible(1.0f, g, b, e, cc, c);
  float lo = 0.0f, hi = 1.0f;
  for (int it = 0; it < kBisect; ++it) {
    const float mid = 0.5f * (lo + hi);
    const bool ok = repro::bisection_feasible(mid, g, b, e, cc, c);
    lo = ok ? mid : lo;
    hi = ok ? hi : mid;
  }
  const float a = feas1 ? 1.0f : lo;
  const float p = repro::p_min_numerator(a, b, c) / g;
  a_out[i] = a;
  p_out[i] = repro::nan_min(repro::nan_max(p, 0.0f), c.p_max);
}

unsigned int blocks_for(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int repro_fused_solve(const float* pg, const float* bw,
                                 const float* emax, const float* ec,
                                 float* a_out, float* p_out, long long n,
                                 float s_bits, float tau, float p_max,
                                 float p_feasible, int n_iters,
                                 int faithful_eq13_typo, void* stream) {
  if (n > 0) {
    const repro::SolveScalars c{s_bits, tau, p_max, p_feasible,
                                faithful_eq13_typo};
    fused_solve_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        pg, bw, emax, ec, a_out, p_out, n, c, n_iters);
  }
  return (int)cudaGetLastError();
}

extern "C" int repro_selection_solve(const float* pg, const float* bw,
                                     const float* emax, const float* ec,
                                     float* a_out, float* p_out, long long n,
                                     float s_bits, float tau, float p_max,
                                     void* stream) {
  if (n > 0) {
    const repro::SolveScalars c{s_bits, tau, p_max, p_max, 0};
    selection_solve_kernel<<<blocks_for(n), kThreads, 0,
                             (cudaStream_t)stream>>>(pg, bw, emax, ec, a_out,
                                                     p_out, n, c);
  }
  return (int)cudaGetLastError();
}
