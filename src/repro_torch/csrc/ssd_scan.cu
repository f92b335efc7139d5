// Mamba2 SSD chunked scan, chunk-parallel.
//
// The four kernels here together replace the Pallas TPU kernel
// ssd_scan_tiled (_kernel) of src/repro/kernels/ssd_scan/kernel.py.  For a
// chunk of cs steps, with cum the inclusive cumulative sum of dt * a over
// the chunk and total = cum[cs - 1]:
//   y[l]  = sum_{s <= l} (C[l] . B[s]) exp(cum[l] - cum[s]) dt[s] x[s]
//         + exp(cum[l]) (C[l] . S_in) + D x[l]
//   S_out = exp(total) S_in + sum_s x[s] (B[s] exp(total - cum[s]) dt[s])^T
// Operands in the model's layout: x [B, S, H, P], dt [B, S, H], a [H],
// B/C [B, S, N] (shared by the heads, read by batch row), D [H]; an
// optional initial state and the final state [B, H, P, N].  Unlike the
// TPU kernel's wrapper, nothing is repeated over heads or transposed.
//
// What bounds it on this card: operations.  Per (batch row, chunk) the
// least work is about cs^2 (N + H P) / 2 + 2 cs H P N multiply-adds
// against (2 H P + 2 N + H) cs floats moved; at mamba2-780m's widths that
// is about 90 operations per byte, above the card's 20 for float32 (67
// TFLOP/s over 3.35 TB/s) and its 49 for the 3xTF32 products below (495
// TFLOP/s of TF32 over three).  Nearly all of that work is the products,
// so the least time is theirs at the 3xTF32 rate.
//
// Design: the passes of the SSD paper's GPU algorithm (Dao and Gu 2024,
// section 6), chunks in parallel, four launches on one stream:
//   1. ssd_scan_scores_kernel, per (batch row, chunk, 64 x 64 tile of the
//      lower triangle): C . B^T once, shared by all heads, into scratch
//      scores [B, nc, cs, cs] (the upper tiles are never written or read);
//   2. ssd_scan_states_kernel, per (batch row, chunk, head): the inclusive
//      cumsum of dt * a, in order on one thread (as the plain version's
//      cumsum along a non-innermost dimension, so that cum[l] - cum[s]
//      cancels the same digits in both), into scratch cum [B, nc, H, cs];
//      and the chunk state S_c[p, n] = sum_s x[s, p] w[s] B[s, n], with
//      w[s] = exp(total - cum[s]) dt[s], into scratch states [B, nc, H, P, N];
//   3. ssd_scan_carry_kernel, per (batch row, head, p, n), in order over the
//      chunks: entering[c] = carry, carry = carry exp(total_c) + S_c.  It
//      writes entering[c] in place over pass 2's S_c, and the last carry
//      is the final state.  The only serial chain left, bound by memory;
//   4. ssd_scan_out_kernel, per (batch row, chunk, head): the inter term
//      exp(cum[l]) (C . S_in^T) first, then D x and the intra term on top:
//      pass 1's scores masked, decayed and weighted by dt, times x, over
//      the causal triangle only.  Each k-tile's decayed scores are made in
//      place by the whole block, each entry once, and its x split into
//      TF32 head and rest once, before the warps' products read them.
// The products of passes 1, 2 and 4 run on the tensor cores through
// mma.sync m16n8k8 TF32 with the 3xTF32 split (a = a_hi + a_lo; a b ~ a_hi
// b_hi + a_hi b_lo + a_lo b_hi), which keeps float32 accuracy.  Each warp
// owns a register tile of 2 x 4 (passes 1, 2) or 2 x 8 (pass 4) of those
// 16 x 8 outputs, so one shared-memory load feeds 4 or 8 products; the
// operand tiles of passes 2 and 4 stream in by cp.async into a double
// buffer, in k-tiles of 32.  Dynamic shared memory a block, held by the
// static_asserts beside the layouts: 67,584 bytes (pass 1), 56,320 (pass
// 2), none (pass 3), 112,640 (pass 4, two blocks an SM).  In pass 4 warp
// w owns the 16-row tiles w and 15 - w, so that the triangle's work is
// even across warps.  Above the diagonal the exponent cum[l] - cum[s] is
// positive and may overflow: the entry is selected to 0, never multiplied
// by a mask, and exp is never split into exp(cum[l]) exp(-cum[s]).  Everything outside the products
// is float32 on the CUDA cores with the accurate expf; the build's
// --fmad=false keeps each product and sum rounded apart, as in the plain
// version.  Bounds checks and zero-filled tiles give any P <= 64,
// N <= 128 and cs <= 256.
// Left for later: wgmma and TMA (TF32 wgmma needs both operands K-major in
// shared memory), and fusing the passes.
#include "ssd_mma.cuh"

namespace {

constexpr int kT1 = 64;             // pass 1's score tile

// ------------------------------------------------------ pass 1: C . B^T

constexpr int kThreads1 = 128;

struct Smem1 {
  float c[kT1][kLdN];
  float b[kT1][kLdN];
};
static_assert(sizeof(Smem1) == 67584, "ssd_scan_scores_kernel: dynamic shared memory");

__global__ void __launch_bounds__(kThreads1)
    ssd_scan_scores_kernel(const float* __restrict__ bm,
                           const float* __restrict__ cm,
                           float* __restrict__ scores, int n, int cs, int ntri,
                           bool vec_bc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem1& sm = *reinterpret_cast<Smem1*>(smem_raw);
  const int bc = blockIdx.x / ntri;            // b * nc + c
  const int tri = blockIdx.x - bc * ntri;      // tile (ti, tj), tj <= ti
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= tri) ++ti;
  const int tj = tri - ti * (ti + 1) / 2;
  const int l0 = ti * kT1;
  const int s0 = tj * kT1;
  const long long t0 = (long long)bc * cs;     // the chunk's first step
  load_tile(&sm.c[0][0], kLdN, cm + (t0 + l0) * n, n, kT1, kMaxN, cs - l0, n,
            vec_bc, cm);
  load_tile(&sm.b[0][0], kLdN, bm + (t0 + s0) * n, n, kT1, kMaxN, cs - s0, n,
            vec_bc, bm);
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp >> 1) * 32;             // rows l of the warp's tile
  const int wn = (warp & 1) * 32;              // columns s
  float acc[2][4][4] = {};
  for (int k0 = 0; k0 < n; k0 += 8) {
    FragA fa[2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      fa[mi] = frag_a([&](int r, int k, int, int) {
        return sm.c[wm + 16 * mi + r][k0 + k];
      }, g, t);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const FragB fb = frag_b([&](int k, int col, int) {
        return sm.b[wn + 8 * ni + col][k0 + k];
      }, g, t);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) mma3(acc[mi][ni], fa[mi], fb);
    }
  }
  float* out = scores + (long long)bc * cs * cs;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int l = l0 + wm + 16 * mi + g + 8 * half;
      if (l >= cs) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int s = s0 + wn + 8 * ni + 2 * t;
        if (s < cs) out[(long long)l * cs + s] = acc[mi][ni][2 * half];
        if (s + 1 < cs) out[(long long)l * cs + s + 1] = acc[mi][ni][2 * half + 1];
      }
    }
}

// ------------------------------------- pass 2: cumsum and chunk states

constexpr int kThreads = 256;

struct Smem2 {
  float x[2][kKT][kLdX];
  float b[2][kKT][kLdB2];
  float dt[kMaxCS];
  float cum[kMaxCS];
  float w[kMaxCS];
};
static_assert(sizeof(Smem2) == 56320, "ssd_scan_states_kernel: dynamic shared memory");

__global__ void __launch_bounds__(kThreads)
    ssd_scan_states_kernel(const float* __restrict__ x,
                           const float* __restrict__ dt,
                           const float* __restrict__ a,
                           const float* __restrict__ bm,
                           float* __restrict__ states, float* __restrict__ cum,
                           int nh, int p, int n, int cs, bool vec_x,
                           bool vec_bc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem2& sm = *reinterpret_cast<Smem2*>(smem_raw);
  const int bc = blockIdx.x / nh;
  const int h = blockIdx.x - bc * nh;
  const long long t0 = (long long)bc * cs;
  const long long xstep = (long long)nh * p;   // x's row stride
  const float* xc = x + t0 * xstep + (long long)h * p;
  const float* bc_ = bm + t0 * n;
  const int nkt = (cs + kKT - 1) / kKT;
  auto load = [&](int kt, int buf) {
    const int s0 = kt * kKT;
    load_tile(&sm.x[buf][0][0], kLdX, xc + s0 * xstep, xstep, kKT, kMaxP,
              cs - s0, p, vec_x, x);
    load_tile(&sm.b[buf][0][0], kLdB2, bc_ + (long long)s0 * n, n, kKT, kMaxN,
              cs - s0, n, vec_bc, bm);
    cp_commit();
  };
  load(0, 0);                  // in flight while the cumsum runs

  for (int i = threadIdx.x; i < kMaxCS; i += kThreads)
    sm.dt[i] = i < cs ? dt[(t0 + i) * nh + h] : 0.0f;
  __syncthreads();
  if (threadIdx.x == 0) {
    // in order, one rounded product and one rounded sum per step
    const float ah = a[h];
    float run = 0.0f;
    for (int i = 0; i < cs; ++i) {
      run += sm.dt[i] * ah;
      sm.cum[i] = run;
    }
  }
  __syncthreads();
  const float total = sm.cum[cs - 1];
  float* cum_out = cum + ((long long)bc * nh + h) * cs;
  for (int i = threadIdx.x; i < kMaxCS; i += kThreads) {
    sm.w[i] = i < cs ? expf(total - sm.cum[i]) * sm.dt[i] : 0.0f;
    if (i < cs) cum_out[i] = sm.cum[i];
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp >> 2) * 32;             // rows p of the warp's tile
  const int wn = (warp & 3) * 32;              // columns n
  const bool active = wm < p && wn < n;
  float acc[2][4][4] = {};
  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) {
      load(kt + 1, (kt + 1) & 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int buf = kt & 1;
    const int s0 = kt * kKT;
    const int kend = min(kKT, cs - s0);
    if (active) {
      for (int k0 = 0; k0 < kend; k0 += 8) {
        const float w0 = sm.w[s0 + k0 + t];
        const float w1 = sm.w[s0 + k0 + t + 4];
        FragA fa[2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          fa[mi] = frag_a([&](int r, int k, int, int kh) {
            return sm.x[buf][k0 + k][wm + 16 * mi + r] * (kh ? w1 : w0);
          }, g, t);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const FragB fb = frag_b([&](int k, int col, int) {
            return sm.b[buf][k0 + k][wn + 8 * ni + col];
          }, g, t);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma3(acc[mi][ni], fa[mi], fb);
        }
      }
    }
    __syncthreads();           // done with buf before it is loaded again
  }
  float* out = states + ((long long)bc * nh + h) * p * n;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pp = wm + 16 * mi + g + 8 * half;
      if (pp >= p) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int nn = wn + 8 * ni + 2 * t;
        if (nn < n) out[(long long)pp * n + nn] = acc[mi][ni][2 * half];
        if (nn + 1 < n) out[(long long)pp * n + nn + 1] = acc[mi][ni][2 * half + 1];
      }
    }
}

// ------------------------------------------- pass 3: the state passing

constexpr int kAhead = 8;                      // chunks whose loads fly together

__global__ void __launch_bounds__(kThreads)
    ssd_scan_carry_kernel(float* __restrict__ states,
                          const float* __restrict__ cum,
                          const float* __restrict__ init,
                          float* __restrict__ final_state, int nc, int nh,
                          int pn, int cs, long long count) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= count) return;                    // count = B H P N
  const long long bh = idx / pn;               // b * nh + h
  const int e = (int)(idx - bh * pn);
  const long long b = bh / nh;
  const int h = (int)(bh - b * nh);
  // S_c of (b, c, h) at ((b nc + c) nh + h) pn + e; total_c at
  // ((b nc + c) nh + h) cs + cs - 1
  float* sp = states + (b * nc * nh + h) * pn + e;
  const float* tp = cum + (b * nc * nh + h) * cs + cs - 1;
  const long long s_step = (long long)nh * pn;
  const long long t_step = (long long)nh * cs;
  float carry = init != nullptr ? init[idx] : 0.0f;
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float sv[kAhead], tv[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (c0 + j < nc) {
        sv[j] = sp[(c0 + j) * s_step];
        tv[j] = tp[(c0 + j) * t_step];
      }
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (c0 + j < nc) {
        sp[(c0 + j) * s_step] = carry;         // entering[c], in place of S_c
        carry = carry * expf(tv[j]) + sv[j];
      }
    }
  }
  final_state[idx] = carry;
}

// ------------------------------------------------ pass 4: the outputs

constexpr int kRowTiles = kMaxCS / 16;         // 16-row tiles of a chunk

struct Smem4 {
  union {
    struct {
      float s_in[kMaxP][kLdN];                 // the state entering the chunk
      float c[2][kMaxCS][kLdK];
    } inter;
    struct {
      float m[2][kMaxCS][kLdK];                // scores, by row l
      float x[2][kKT][kLdX];
      float x_hi[kKT][kLdX];                   // the current tile's x in TF32
      float x_lo[kKT][kLdX];                   // head and rest
    } intra;
  } u;
  float cum[kMaxCS];
  float dt[kMaxCS];
};
static_assert(sizeof(Smem4) == 112640, "ssd_scan_out_kernel: dynamic shared memory");

__global__ void __launch_bounds__(kThreads, 2)
    ssd_scan_out_kernel(const float* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ cm,
                        const float* __restrict__ dskip,
                        const float* __restrict__ scores,
                        const float* __restrict__ states,
                        const float* __restrict__ cum, float* __restrict__ y,
                        int nh, int p, int n, int cs, bool vec_x, bool vec_bc,
                        bool vec_sc, bool vec_st, bool vec_y) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem4& sm = *reinterpret_cast<Smem4*>(smem_raw);
  const int bc = blockIdx.x / nh;
  const int h = blockIdx.x - bc * nh;
  const long long t0 = (long long)bc * cs;
  const long long xstep = (long long)nh * p;
  const float* xc = x + t0 * xstep + (long long)h * p;
  float* yc = y + t0 * xstep + (long long)h * p;
  const float* cc = cm + t0 * n;
  const float* sc = scores + (long long)bc * cs * cs;
  const int rows = min(kMaxCS, (cs + 15) / 16 * 16);   // rows of C, scores read

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int mt[2] = {warp, kRowTiles - 1 - warp};      // the warp's row tiles
  bool live[2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) live[mi] = 16 * mt[mi] < cs;
  const int np8 = (p + 7) / 8;                         // live column tiles

  // the inter term, C S_in^T, over k-tiles of n
  const int nkn = (n + kKT - 1) / kKT;
  auto load_c = [&](int kt, int buf) {
    load_tile(&sm.u.inter.c[buf][0][0], kLdK, cc + kt * kKT, n, rows, kKT, cs,
              n - kt * kKT, vec_bc, cm);
    cp_commit();
  };
  load_tile(&sm.u.inter.s_in[0][0], kLdN,
            states + ((long long)bc * nh + h) * p * n, n, kMaxP, kMaxN, p, n,
            vec_st, states);
  load_c(0, 0);
  const float* cum_c = cum + ((long long)bc * nh + h) * cs;
  for (int i = threadIdx.x; i < kMaxCS; i += kThreads) {
    sm.cum[i] = i < cs ? cum_c[i] : 0.0f;
    sm.dt[i] = i < cs ? dt[(t0 + i) * nh + h] : 0.0f;
  }

  float acc[2][8][4] = {};
  for (int kt = 0; kt < nkn; ++kt) {
    if (kt + 1 < nkn) {
      load_c(kt + 1, (kt + 1) & 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int buf = kt & 1;
    const int n0 = kt * kKT;
    const int kend = min(kKT, n - n0);
    for (int k0 = 0; k0 < kend; k0 += 8) {
      FragA fa[2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        if (live[mi])
          fa[mi] = frag_a([&](int r, int k, int, int) {
            return sm.u.inter.c[buf][16 * mt[mi] + r][k0 + k];
          }, g, t);
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        if (ni >= np8) break;
        const FragB fb = frag_b([&](int k, int col, int) {
          return sm.u.inter.s_in[8 * ni + col][n0 + k0 + k];
        }, g, t);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          if (live[mi]) mma3(acc[mi][ni], fa[mi], fb);
      }
    }
    __syncthreads();
  }

  // scale by exp(cum[l])
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float e = expf(sm.cum[16 * mt[mi] + g + 8 * half]);
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) acc[mi][ni][2 * half + j] *= e;
    }

  // the intra term over k-tiles of s, the causal triangle only
  const int nks = (cs + kKT - 1) / kKT;
  auto load_m = [&](int kt, int buf) {
    const int s0 = kt * kKT;
    load_tile(&sm.u.intra.m[buf][s0][0], kLdK, sc + (long long)s0 * cs + s0, cs,
              rows - s0, kKT, cs - s0, cs - s0, vec_sc, scores);
    load_tile(&sm.u.intra.x[buf][0][0], kLdX, xc + s0 * xstep, xstep, kKT,
              kMaxP, cs - s0, p, vec_x, x);
    cp_commit();
  };
  const float dh = dskip[h];
  load_m(0, 0);
  for (int kt = 0; kt < nks; ++kt) {
    if (kt + 1 < nks) {
      load_m(kt + 1, (kt + 1) & 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int buf = kt & 1;
    const int s0 = kt * kKT;
    const int kend = min(kKT, cs - s0);
    // D x for the warp's rows in this tile
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * mt[mi] + g + 8 * half - s0;
        if (!live[mi] || r < 0 || r >= kKT) continue;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            acc[mi][ni][2 * half + j] += dh * sm.u.intra.x[buf][r][8 * ni + 2 * t + j];
      }
    // the whole block turns the tile's scores into the masked, decayed and
    // dt-weighted entries, each once and in place, and splits x once
    for (int i = threadIdx.x; i < (rows - s0) * kKT; i += kThreads) {
      const int l = s0 + i / kKT;
      const int s = s0 + i % kKT;
      float& e = sm.u.intra.m[buf][l][s - s0];
      // select, never multiply by the mask: exp overflows above it
      e = (s <= l && l < cs) ? e * expf(sm.cum[l] - sm.cum[s]) * sm.dt[s] : 0.0f;
    }
    for (int i = threadIdx.x; i < kKT * kMaxP; i += kThreads) {
      const int r = i / kMaxP;
      const int c = i % kMaxP;
      uint32_t hi, lo;
      split_tf32(sm.u.intra.x[buf][r][c], hi, lo);
      sm.u.intra.x_hi[r][c] = __uint_as_float(hi);
      sm.u.intra.x_lo[r][c] = __uint_as_float(lo);
    }
    __syncthreads();
    for (int k0 = 0; k0 < kend; k0 += 8) {
      FragA fa[2];
      bool on[2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        // some s of this step at or below some row of the tile
        on[mi] = live[mi] && s0 + k0 <= 16 * mt[mi] + 15;
        if (on[mi])
          fa[mi] = frag_a([&](int r, int k, int, int) {
            return sm.u.intra.m[buf][16 * mt[mi] + r][k0 + k];
          }, g, t);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        if (ni >= np8) break;
        const FragB fb = frag_b_split(
            [&](int k, int col) { return sm.u.intra.x_hi[k0 + k][8 * ni + col]; },
            [&](int k, int col) { return sm.u.intra.x_lo[k0 + k][8 * ni + col]; },
            g, t);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          if (on[mi]) mma3(acc[mi][ni], fa[mi], fb);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int l = 16 * mt[mi] + g + 8 * half;
      if (!live[mi] || l >= cs) continue;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        if (ni >= np8) break;
        const int pc = 8 * ni + 2 * t;
        float* dst = yc + l * xstep + pc;
        if (pc + 1 < p && vec_y) {
          *reinterpret_cast<float2*>(dst) =
              make_float2(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
        } else {
          if (pc < p) dst[0] = acc[mi][ni][2 * half];
          if (pc + 1 < p) dst[1] = acc[mi][ni][2 * half + 1];
        }
      }
    }
}

}  // namespace

// init may be null (a zero initial state).  P <= 64, N <= 128, chunk <= 256
// and S % chunk == 0.  Scratch, nc = S / chunk: scores [B, nc, chunk,
// chunk], states [B, nc, H, P, N], cum [B, nc, H, chunk].  Four launches
// on the stream; returns the first error.
extern "C" int repro_ssd_scan(const float* x, const float* dt, const float* a,
                              const float* bm, const float* cm,
                              const float* dskip, const float* init, float* y,
                              float* final_state, float* scores, float* states,
                              float* cum, int b, int s, int nh, int p, int n,
                              int cs, void* stream) {
  if (b <= 0 || s <= 0 || nh <= 0 || p <= 0 || p > kMaxP || n <= 0 ||
      n > kMaxN || cs <= 0 || cs > kMaxCS || s % cs != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nc = s / cs;
  const int nt = (cs + kT1 - 1) / kT1;
  const int ntri = nt * (nt + 1) / 2;
  const bool vec_x = p % 4 == 0 && aligned16(x);
  const bool vec_bc = n % 4 == 0 && aligned16(bm) && aligned16(cm);
  const bool vec_sc = cs % 4 == 0 && aligned16(scores);
  const bool vec_st = n % 4 == 0 && aligned16(states);
  const bool vec_y = p % 2 == 0 && ((uintptr_t)y & 7) == 0;
  cudaError_t err;
  if ((err = set_smem(ssd_scan_scores_kernel, sizeof(Smem1))) != cudaSuccess ||
      (err = set_smem(ssd_scan_states_kernel, sizeof(Smem2))) != cudaSuccess ||
      (err = set_smem(ssd_scan_out_kernel, sizeof(Smem4))) != cudaSuccess)
    return (int)err;
  ssd_scan_scores_kernel<<<b * nc * ntri, kThreads1, sizeof(Smem1), st>>>(
      bm, cm, scores, n, cs, ntri, vec_bc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_scan_states_kernel<<<b * nc * nh, kThreads, sizeof(Smem2), st>>>(
      x, dt, a, bm, states, cum, nh, p, n, cs, vec_x, vec_bc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long count = (long long)b * nh * p * n;
  ssd_scan_carry_kernel<<<(unsigned)((count + kThreads - 1) / kThreads), kThreads,
                          0, st>>>(states, cum, init, final_state, nc, nh, p * n,
                                   cs, count);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_scan_out_kernel<<<b * nc * nh, kThreads, sizeof(Smem4), st>>>(
      x, dt, cm, dskip, scores, states, cum, y, nh, p, n, cs, vec_x, vec_bc,
      vec_sc, vec_st, vec_y);
  return (int)cudaGetLastError();
}
