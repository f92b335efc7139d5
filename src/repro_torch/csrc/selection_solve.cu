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
// Both loops are fixed point iterations of a state held in registers: the
// fused step is a function of a alone (P is recomputed from a every step),
// a bisection step a function of (lo, hi) alone.  Once a step leaves that
// state's bits unchanged, every later step repeats it, so each element
// stops there (or at the fixed trip count) and writes the outputs the
// fixed trip count would: bit for bit, with no tolerance.  The test is on
// the bits (__float_as_uint), not the values: -0 and +0 divide apart, and
// an element whose state keeps changing (a 2-cycle, a NaN that is
// recomputed) runs the full count.  Where a = 1 is feasible the reference
// discards the bisection (a = where(feas1, 1, lo)), so none is run.
//
// What bounds them on this card: arithmetic on the steps an element
// needs.  Each element reads 16 bytes and writes 8, then runs its steps
// of float32 divisions, logf and expm1f; on the registry's batches a fused
// element settles after about 1.5 of its 50 steps and a bisection after
// about 30 of 60 (an infeasible or padded element never settles: hi halves
// towards 2^-60).  A warp runs until its slowest lane stops, so the warp's
// largest count, not the mean, sets the issued work.  At the slice's shape
// (100 elements) a launch is one block and the time is the launch latency.
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
  // the first step is iteration 1, as in fused_fixed_point: n_iters steps,
  // at least one, or fewer once a step leaves a's bits unchanged
  const int steps = n_iters > 1 ? n_iters : 1;
  for (int it = 0; it < steps; ++it) {
    const unsigned int prev = __float_as_uint(a);
    repro::fused_step(a, p, g, b, e, cc, c);
    if (__float_as_uint(a) == prev) break;
  }
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
  // no bisection where a = 1 is feasible (its lo is discarded); a step
  // replaces lo (ok) or hi by mid, so it leaves (lo, hi) unchanged when mid
  // has the bits of the end it replaces
  const int steps = feas1 ? 0 : kBisect;
  for (int it = 0; it < steps; ++it) {
    const float mid = 0.5f * (lo + hi);
    const bool ok = repro::bisection_feasible(mid, g, b, e, cc, c);
    const unsigned int moved = __float_as_uint(ok ? lo : hi);
    lo = ok ? mid : lo;
    hi = ok ? hi : mid;
    if (__float_as_uint(mid) == moved) break;
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
