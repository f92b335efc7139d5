// Per-element closed forms of problem (7), shared by the two solve kernels.
//
// Each helper restates one function of repro_torch.core (power.py,
// selection.py, alternating.py) in float32 with the same operation order,
// so that a kernel and its plain PyTorch version round alike.  The library
// is built with --fmad=false (no a*b+c contraction) and without
// --use_fast_math: P^min needs expm1f's accuracy as a -> 0.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace repro {

constexpr float kLn2 = 0.6931471805599453f;

// jnp.minimum / jnp.maximum (and torch's) propagate a NaN operand;
// fminf / fmaxf would drop it.
__device__ __forceinline__ float nan_min(float x, float y) {
  return (x != x || y != y) ? x + y : fminf(x, y);
}
__device__ __forceinline__ float nan_max(float x, float y) {
  return (x != x || y != y) ? x + y : fmaxf(x, y);
}

// log2 as the reference evaluates it: log(x) / ln 2 in float32.
__device__ __forceinline__ float log2_ref(float x) { return logf(x) / kLn2; }

struct SolveScalars {
  float s_bits;        // payload S in bits
  float tau;           // tau^th
  float p_max;         // P^max
  float p_feasible;    // float32(P^max * (1 + 1e-6)), the power gate
  int faithful_eq13_typo;
};

// 2^{a S / (B tau)} - 1 with the exponent clamped at 120.
__device__ __forceinline__ float p_min_numerator(float a, float bw,
                                                 const SolveScalars& c) {
  const float expo = nan_min(a * c.s_bits / (bw * c.tau), 120.0f);
  return expm1f(expo * kLn2);
}

// element_p_min: a gain that is not positive gates the element to inf.
__device__ __forceinline__ float element_p_min(float a, float pg, float bw,
                                               const SolveScalars& c) {
  const float num = p_min_numerator(a, bw, c);
  return pg > 0.0f ? num / pg : INFINITY;
}

// element_tx_time: T(P) = S / max(B log2(1 + P pg), 1e-30).
__device__ __forceinline__ float element_tx_time(float p, float pg, float bw,
                                                 const SolveScalars& c) {
  return c.s_bits / nan_max(bw * log2_ref(1.0f + p * pg), 1e-30f);
}

// selection_update_elements: eq. (13), clipped to [0, 1].
__device__ __forceinline__ float selection_update(float p, float t,
                                                  float emax, float ec,
                                                  const SolveScalars& c) {
  float time_term = c.tau / nan_max(t, 1e-30f);
  if (c.faithful_eq13_typo) time_term = time_term / c.s_bits;
  const float energy_term = emax / nan_max(p * t + ec, 1e-30f);
  float a = nan_min(nan_min(1.0f, time_term), energy_term);
  a = p > 0.0f ? a : 0.0f;
  return nan_min(nan_max(a, 0.0f), 1.0f);
}

// fused_init: transmit at P^max, a^0 from eq. (13).
__device__ __forceinline__ float fused_init(float pg, float bw, float emax,
                                            float ec, const SolveScalars& c) {
  const float t0 = element_tx_time(c.p_max, pg, bw, c);
  return selection_update(c.p_max, t0, emax, ec, c);
}

// _fused_step in analytic mode: P = clip(P^min(a), 0, P^max), the eq.-10
// energy gate with the power gate, then eq. (13); a gated element keeps a.
__device__ __forceinline__ void fused_step(float& a, float& p, float pg,
                                           float bw, float emax, float ec,
                                           const SolveScalars& c) {
  const float p_min = nan_max(element_p_min(a, pg, bw, c), 0.0f);
  const bool feasible = p_min <= c.p_feasible;
  const float p_new = nan_min(p_min, c.p_max);
  const float t = element_tx_time(p_new, pg, bw, c);
  const float lam = a > 0.0f ? nan_max(a, 1e-12f) * p_new * t : 0.0f;
  const bool ok = (lam <= (emax - a * ec) + 1e-9f) && feasible;
  const float a_new = selection_update(p_new, t, emax, ec, c);
  a = ok ? a_new : a;
  p = p_new;
}

// The selection_solve kernel's own F(a): no pg > 0 gate, unlike
// element_p_min (the reference kernel divides by pg as it is).
__device__ __forceinline__ bool bisection_feasible(float a, float pg,
                                                   float bw, float emax,
                                                   float ec,
                                                   const SolveScalars& c) {
  const float p_min = p_min_numerator(a, bw, c) / pg;
  return (p_min <= c.p_max) && (c.tau * p_min + a * ec <= emax);
}

}  // namespace repro
