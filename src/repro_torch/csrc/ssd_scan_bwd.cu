// Backward of the Mamba2 SSD chunked scan of ssd_scan.cu, chunk-parallel.
//
// It replaces no TPU kernel: the reference has no Pallas backward for
// ssd_scan_tiled and trains mamba2 by jax's autodiff of the plain jnp
// ssd_chunked (src/repro/models/mamba2.py:83).  This is the port's kernel
// for that gradient; ref.ssd_bwd_passes_ref is the same passes in plain
// PyTorch.  The forward's notation, per (batch row b, chunk c, head h):
// cum the decays' inclusive cumsum, total = cum[cs - 1], e[l] = exp(cum[l]),
// G = C.B^T, L[l, s] = exp(cum[l] - cum[s]) on s <= l, M = G L dt[s],
// w[s] = exp(total - cum[s]) dt[s], S_in the state entering the chunk.
// Given dy [B, S, H, P] and d_final [B, H, P, N] (null: zeros), and the
// forward's scratch (cum [B, nc, H, cs], the entering states [B, nc, H, P,
// N], C.B^T [B, nc, cs, cs]), six launches on one stream:
//   1. ssd_bwd_dstate_kernel, per (b, c, h): dS_inter = sum_l e[l] dy[l]
//      C[l]^T, the forward's pass 2 with dy for x, C for B and e for w,
//      into scratch dstates [B, nc, H, P, N];
//   2. ssd_bwd_carry_kernel, per (b, h, p, n), in reverse over the chunks:
//      the transpose of the forward's pass 3.  g = d_final; dstates[c]
//      takes g, the gradient of the chunk's state S_c, in place of
//      dS_inter, and g = exp(total_c) g + dS_inter; the last g is
//      d_init_state;
//   3. ssd_bwd_chunk_kernel, per (b, c, h): dx = w (B dS^T) + D dy + M^T dy,
//      complete; the decays' gradient dcum from the inter term (e[l] dy[l]
//      . (C S_in^T)[l]), the intra term (row sums of dM M and column sums
//      of dM G L over the strict lower triangle, dM = dy x^T), the state
//      term (dw = x . (B dS^T), times w) and the carry (exp(total) dS .
//      S_in); then, in order on one thread, dcum summed in reverse along
//      the chunk, which completes dt's gradient and gives the chunk's
//      partials of a's and D's, into scratch parts [2, B, nc, H];
//   4. ssd_bwd_dg_kernel, per (b, c, 64 x 64 tile of the lower triangle):
//      dG = sum_h (dy_h x_h^T) L_h dt_h, the heads in order, into scratch
//      dg [B, nc, cs, cs] (the upper tiles are never written or read);
//   5. ssd_bwd_bc_kernel, per (b, c, 64 rows, C or B): dC = sum_h (e_h dy_h)
//      S_in,h + dG B and dB = sum_h (w_h x_h) dS_h + dG^T C, complete;
//   6. ssd_bwd_reduce_kernel: a's and D's gradients, the partials summed
//      over batch rows and chunks in order.
// What bounds it on this card: operations, as the forward.  Per (batch
// row, chunk) its least products are about cs^2 (H P + N) (the intra term
// twice, dG's products with B and C) + 5 cs H P N (the state and inter
// terms) multiply-adds, about twice the forward's intra term and two and a
// half times its state term, at the 3xTF32 rate.
// Deterministic: no atomics, and every sum runs in a fixed order (the
// heads in order, register tiles reduced by fixed shuffles, shared-memory
// partials summed in order), so two calls give the same bits.  Numerics as
// the forward's: the products in 3xTF32 on the tensor cores, everything
// else float32 with the accurate expf under --fmad=false; above the
// diagonal the exponent is selected, never multiplied by a mask.  The
// diagonal's decay exp(cum[l] - cum[l]) and the last step's weight
// exp(total - cum[cs - 1]) hold no decay: their terms of dcum, which cancel
// exactly, are left out rather than added and subtracted (where dt is
// large their rounding would swamp the gradient of a).
// The design is the simple one: single-buffered cp.async tiles and
// mma.sync, each pass a launch of its own.  Left for later: double
// buffering, wgmma and TMA, and fusing passes 3-5.
#include "ssd_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTD = 64;                 // dG's tiles, and pass 5's rows
constexpr int kLT = 32;                 // pass 3's tile of l
constexpr int kLdX4 = kMaxP + 4;        // x, dy by rows, read at (g, t)
constexpr int kLdM = kMaxCS + 8;        // pass 3's M tile, read at (t, g)
constexpr int kRowTiles = kMaxCS / 16;  // 16-row tiles of a chunk
constexpr int kAhead = 8;               // chunks whose loads fly together

// One k-step of 8 of a warp's register tile: acc[mi][ni] += A B over depth
// k0 .. k0 + 7, where a(mi, r, k) is A's entry at row r of the warp's row
// tile mi and depth k, and b(ni, k, c) B's at depth k and column c of its
// column tile ni.  Row tiles with on[mi] false and column tiles from nn on
// are skipped.  acc[mi][ni][2 * half + j] holds row g + 8 half and column
// 2 t + j of its 16 x 8 tile.
template <int MI, int NI, class FA, class FB>
__device__ __forceinline__ void mma_step(float (&acc)[MI][NI][4],
                                         const bool (&on)[MI], int nn, int k0,
                                         FA a, FB b, int g, int t) {
  FragA fa[MI];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
    if (on[mi])
      fa[mi] = frag_a([&](int r, int k, int, int) { return a(mi, r, k0 + k); },
                      g, t);
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    if (ni >= nn) break;
    const FragB fb =
        frag_b([&](int k, int c, int) { return b(ni, k0 + k, c); }, g, t);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
      if (on[mi]) mma3(acc[mi][ni], fa[mi], fb);
  }
}

template <int MI, int NI>
__device__ __forceinline__ void zero(float (&acc)[MI][NI][4]) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
}

// the sum over a quad's 4 lanes (a row's columns in a register tile)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// the sum over the 8 quads (a column's rows in a register tile)
__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// Writes a warp's register tile of 2 x 4 16 x 8 tiles at rows wm, columns
// wn of out (row stride ld), the rows below nr and the columns below nc.
__device__ __forceinline__ void store_tile(float* out, long long ld,
                                           const float (&acc)[2][4][4], int wm,
                                           int wn, int nr, int nc, int g, int t) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm + 16 * mi + g + 8 * half;
      if (r >= nr) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = wn + 8 * ni + 2 * t + j;
          if (c < nc) out[r * ld + c] = acc[mi][ni][2 * half + j];
        }
    }
}

// ------------------------------------------ pass 1: dS through the outputs

struct SmemD {
  float dy[kKT][kLdX];
  float c[kKT][kLdB2];
  float e[kMaxCS];
};
static_assert(sizeof(SmemD) == 27648, "ssd_bwd_dstate_kernel: dynamic shared memory");

__global__ void __launch_bounds__(kThreads)
    ssd_bwd_dstate_kernel(const float* __restrict__ dy,
                          const float* __restrict__ cm,
                          const float* __restrict__ cum,
                          float* __restrict__ dstates, int nh, int p, int n,
                          int cs, bool vec_x, bool vec_bc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemD& sm = *reinterpret_cast<SmemD*>(smem_raw);
  const int bc = blockIdx.x / nh;
  const int h = blockIdx.x - bc * nh;
  const long long t0 = (long long)bc * cs;
  const long long xstep = (long long)nh * p;
  const float* dyc = dy + t0 * xstep + (long long)h * p;
  const float* cc = cm + t0 * n;
  const float* cum_c = cum + ((long long)bc * nh + h) * cs;
  for (int i = threadIdx.x; i < kMaxCS; i += kThreads)
    sm.e[i] = i < cs ? expf(cum_c[i]) : 0.0f;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp >> 2) * 32;             // rows p of the warp's tile
  const int wn = (warp & 3) * 32;              // columns n
  const bool on[2] = {wm < p, wm + 16 < p};
  const int nn = wn < n ? min(4, (n - wn + 7) / 8) : 0;
  float acc[2][4][4] = {};
  for (int l0 = 0; l0 < cs; l0 += kKT) {
    load_tile(&sm.dy[0][0], kLdX, dyc + l0 * xstep, xstep, kKT, kMaxP, cs - l0,
              p, vec_x, dy);
    load_tile(&sm.c[0][0], kLdB2, cc + (long long)l0 * n, n, kKT, kMaxN,
              cs - l0, n, vec_bc, cm);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    const int kend = min(kKT, cs - l0);
    for (int k0 = 0; k0 < kend; k0 += 8)
      mma_step(acc, on, nn, k0,
               [&](int mi, int r, int k) {
                 return sm.dy[k][wm + 16 * mi + r] * sm.e[l0 + k];
               },
               [&](int ni, int k, int c) { return sm.c[k][wn + 8 * ni + c]; },
               g, t);
    __syncthreads();           // done with the tiles before they are loaded again
  }
  store_tile(dstates + ((long long)bc * nh + h) * p * n, n, acc, wm, wn, p, n, g,
             t);
}

// ------------------------------ pass 2: the state passing, transposed

__global__ void __launch_bounds__(kThreads)
    ssd_bwd_carry_kernel(float* __restrict__ dstates,
                         const float* __restrict__ cum,
                         const float* __restrict__ d_final,
                         float* __restrict__ d_init, int nc, int nh, int pn,
                         int cs, long long count) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= count) return;                    // count = B H P N
  const long long bh = idx / pn;               // b * nh + h
  const int e = (int)(idx - bh * pn);
  const long long b = bh / nh;
  const int h = (int)(bh - b * nh);
  float* sp = dstates + (b * nc * nh + h) * pn + e;
  const float* tp = cum + (b * nc * nh + h) * cs + cs - 1;
  const long long s_step = (long long)nh * pn;
  const long long t_step = (long long)nh * cs;
  float g = d_final != nullptr ? d_final[idx] : 0.0f;
  for (int c1 = nc; c1 > 0; c1 -= kAhead) {    // chunks c1 - 1 down
    float sv[kAhead], tv[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int c = c1 - 1 - j;
      if (c >= 0) {
        sv[j] = sp[c * s_step];
        tv[j] = tp[c * t_step];
      }
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int c = c1 - 1 - j;
      if (c >= 0) {
        sp[c * s_step] = g;                    // dS_c, in place of dS_inter
        g = g * expf(tv[j]) + sv[j];
      }
    }
  }
  d_init[idx] = g;
}

// ------------------------------------- pass 3: dx, dt and the partials

struct Smem3 {
  float x[kMaxCS][kLdX4];
  float dy[kMaxCS][kLdX4];
  union {
    struct {
      float bc[kMaxCS][kLdK];                  // a k-tile of C or B, by row
      float st[kMaxP][kLdK];                   // of S_in or dS, by row p
    } a;
    struct {
      float m[kLT][kLdM];                      // an l-tile's G, then its M
      float rowpart[kThreads / 32][kLT];       // each warp's row sums
    } b;
  } u;
  float cum[kMaxCS];
  float dt[kMaxCS];
  float decay[kMaxCS];                         // exp(total - cum)
  float w[kMaxCS];
  float dcum[kMaxCS];
  float dw[kMaxCS];
  float colt[kMaxCS];                          // below the diagonal
  float diagt[kMaxCS];
  float rowq[kMaxCS];
  float red[2][kThreads];
};
static_assert(sizeof(Smem3) == 196608, "ssd_bwd_chunk_kernel: dynamic shared memory");

__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_chunk_kernel(const float* __restrict__ dy,
                         const float* __restrict__ x,
                         const float* __restrict__ dt,
                         const float* __restrict__ av,
                         const float* __restrict__ bm,
                         const float* __restrict__ cm,
                         const float* __restrict__ dskip,
                         const float* __restrict__ cum,
                         const float* __restrict__ states,
                         const float* __restrict__ dstates,
                         const float* __restrict__ scores,
                         float* __restrict__ dx, float* __restrict__ ddt,
                         float* __restrict__ parts, int nh, int p, int n,
                         int cs, long long nbch, bool vec_x, bool vec_bc,
                         bool vec_sc, bool vec_st) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem3& sm = *reinterpret_cast<Smem3*>(smem_raw);
  const int bc = blockIdx.x / nh;
  const int h = blockIdx.x - bc * nh;
  const long long sidx = (long long)bc * nh + h;
  const long long t0 = (long long)bc * cs;
  const long long xstep = (long long)nh * p;
  const float* s_in = states + sidx * p * n;
  const float* ds = dstates + sidx * p * n;
  const int rows32 = min(kMaxCS, (cs + 31) / 32 * 32);
  const int rows16 = min(kMaxCS, (cs + 15) / 16 * 16);
  load_tile(&sm.x[0][0], kLdX4, x + t0 * xstep + (long long)h * p, xstep, rows32,
            kMaxP, cs, p, vec_x, x);
  load_tile(&sm.dy[0][0], kLdX4, dy + t0 * xstep + (long long)h * p, xstep,
            rows32, kMaxP, cs, p, vec_x, dy);
  cp_commit();
  const float* cum_c = cum + sidx * cs;
  for (int i = threadIdx.x; i < kMaxCS; i += kThreads) {
    sm.cum[i] = i < cs ? cum_c[i] : 0.0f;
    sm.dt[i] = i < cs ? dt[(t0 + i) * nh + h] : 0.0f;
    sm.colt[i] = 0.0f;
    sm.diagt[i] = 0.0f;
  }
  __syncthreads();
  const float total = sm.cum[cs - 1];
  for (int i = threadIdx.x; i < kMaxCS; i += kThreads) {
    sm.decay[i] = i < cs ? expf(total - sm.cum[i]) : 0.0f;
    sm.w[i] = sm.decay[i] * sm.dt[i];
  }
  // the carry's dot dS . S_in, each thread's share (summed in order below)
  {
    float v = 0.0f;
    for (int i = threadIdx.x; i < p * n; i += kThreads) v += ds[i] * s_in[i];
    sm.red[0][threadIdx.x] = v;
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int mt[2] = {warp, kRowTiles - 1 - warp};      // the warp's row tiles
  bool live[2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) live[mi] = 16 * mt[mi] < cs;
  const int np8 = (p + 7) / 8;                         // live column tiles
  const float dh = dskip[h];

  // [cs x P] products over n: rows of rsrc (C or B) times st (S_in or dS)^T
  float acc[2][8][4];
  auto product_over_n = [&](const float* rsrc, const float* st) {
    zero(acc);
    for (int n0 = 0; n0 < n; n0 += kKT) {
      load_tile(&sm.u.a.bc[0][0], kLdK, rsrc + t0 * n + n0, n, rows16, kKT, cs,
                n - n0, vec_bc, bm);
      load_tile(&sm.u.a.st[0][0], kLdK, st + n0, n, kMaxP, kKT, p, n - n0,
                vec_st, states);
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      const int kend = min(kKT, n - n0);
      for (int k0 = 0; k0 < kend; k0 += 8)
        mma_step(acc, live, np8, k0,
                 [&](int mi, int r, int k) { return sm.u.a.bc[16 * mt[mi] + r][k]; },
                 [&](int ni, int k, int c) { return sm.u.a.st[8 * ni + c][k]; },
                 g, t);
      __syncthreads();
    }
  };
  // each row's sum over p of src[row][p] acc[row][p], on the quad's lanes
  auto row_dot = [&](const auto& src, int mi, int half) {
    const int r = 16 * mt[mi] + g + 8 * half;
    float v = 0.0f;
    if (live[mi]) {
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          v += src[r][8 * ni + 2 * t + j] * acc[mi][ni][2 * half + j];
    }
    return quad_sum(v);
  };

  // the inter term's decays: dcum[l] = e[l] (dy[l] . (C S_in^T)[l])
  product_over_n(cm, s_in);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int l = 16 * mt[mi] + g + 8 * half;
      const float v = row_dot(sm.dy, mi, half);
      if (live[mi] && t == 0 && l < cs) sm.dcum[l] = expf(sm.cum[l]) * v;
    }
  // the state term: U = B dS^T; dw = x . U; dx = w U + D dy
  product_over_n(bm, ds);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int s = 16 * mt[mi] + g + 8 * half;
      const float v = row_dot(sm.x, mi, half);
      if (live[mi] && t == 0 && s < cs) sm.dw[s] = v;
      if (!live[mi]) continue;
      const float ws = sm.w[s];
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float& e = acc[mi][ni][2 * half + j];
          e = ws * e + dh * sm.dy[s][8 * ni + 2 * t + j];
        }
    }

  // the intra term, by tiles of 32 rows l: dM = dy x^T over s <= l, its
  // sums, and dx += M^T dy
  const int nlt = (cs + kLT - 1) / kLT;
  for (int lt = 0; lt < nlt; ++lt) {
    const int l0 = lt * kLT;
    const int ncol = l0 + kLT;                 // columns s < ncol
    load_tile(&sm.u.b.m[0][0], kLdM, scores + (long long)bc * cs * cs + (long long)l0 * cs,
              cs, kLT, ncol, cs - l0, min(ncol, cs), vec_sc, scores);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    if (warp <= lt) {                          // the warp's columns 32 warp ..
      float dm[2][4][4] = {};
      const bool on[2] = {true, true};
      for (int k0 = 0; k0 < p; k0 += 8)
        mma_step(dm, on, 4, k0,
                 [&](int mi, int r, int k) { return sm.dy[l0 + 16 * mi + r][k]; },
                 [&](int ni, int k, int c) { return sm.x[32 * warp + 8 * ni + c][k]; },
                 g, t);
      float rsum[2][2] = {};
      float csum[4][2] = {};
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int l = l0 + 16 * mi + g + 8 * half;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int s = 32 * warp + 8 * ni + 2 * t + j;
              float& gm = sm.u.b.m[l - l0][s];
              if (s <= l && l < cs) {
                // select, never multiply by the mask: exp overflows above it
                const float gl = gm * expf(sm.cum[l] - sm.cum[s]);
                const float mm = gl * sm.dt[s];
                const float d = dm[mi][ni][2 * half + j];
                if (s < l) {
                  rsum[mi][half] += d * mm;
                  csum[ni][j] += d * gl;
                } else {
                  sm.diagt[s] = d * gl;
                }
                gm = mm;
              } else {
                gm = 0.0f;
              }
            }
        }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float v = quad_sum(rsum[mi][half]);
          if (t == 0) sm.u.b.rowpart[warp][16 * mi + g + 8 * half] = v;
        }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float v = column_sum(csum[ni][j]);
          if (g == 0) sm.colt[32 * warp + 8 * ni + 2 * t + j] += v;
        }
    }
    __syncthreads();
    if (threadIdx.x < kLT) {
      float v = 0.0f;
      for (int w = 0; w <= lt; ++w) v += sm.u.b.rowpart[w][threadIdx.x];
      sm.rowq[l0 + threadIdx.x] = v;
    }
    bool on[2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) on[mi] = live[mi] && 16 * mt[mi] < ncol;
    const int kend = min(kLT, cs - l0);
    for (int k0 = 0; k0 < kend; k0 += 8)
      mma_step(acc, on, np8, k0,
               [&](int mi, int r, int k) { return sm.u.b.m[k][16 * mt[mi] + r]; },
               [&](int ni, int k, int c) { return sm.dy[l0 + k][8 * ni + c]; },
               g, t);
    __syncthreads();           // done with the tile before it is loaded again
  }

  float* dxc = dx + t0 * xstep + (long long)h * p;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int s = 16 * mt[mi] + g + 8 * half;
      if (!live[mi] || s >= cs) continue;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = 8 * ni + 2 * t + j;
          if (c < p) dxc[s * xstep + c] = acc[mi][ni][2 * half + j];
        }
    }
  {
    float v = 0.0f;                            // D's partial: dy . x
    for (int i = threadIdx.x; i < cs * p; i += kThreads) {
      const int r = i / p;
      const int c = i - r * p;
      v += sm.dy[r][c] * sm.x[r][c];
    }
    sm.red[1][threadIdx.x] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // in order on one thread: the decays' gradient, summed in reverse
    float carry = 0.0f, dd = 0.0f;
    for (int i = 0; i < kThreads; ++i) {
      carry += sm.red[0][i];
      dd += sm.red[1][i];
    }
    float dtotal = 0.0f;
    for (int s = 0; s < cs - 1; ++s) dtotal += sm.dw[s] * sm.w[s];
    dtotal = dtotal + expf(total) * carry;
    for (int l = 0; l < cs; ++l) {
      float v = (sm.dcum[l] + sm.rowq[l]) - sm.dt[l] * sm.colt[l];
      if (l < cs - 1) v -= sm.dw[l] * sm.w[l];
      sm.dcum[l] = v;
    }
    sm.dcum[cs - 1] += dtotal;
    float run = 0.0f;
    for (int l = cs - 1; l >= 0; --l) {
      run += sm.dcum[l];
      sm.dcum[l] = run;
    }
    float da = 0.0f;
    for (int s = 0; s < cs; ++s) da += sm.dcum[s] * sm.dt[s];
    parts[sidx] = da;
    parts[nbch + sidx] = dd;
  }
  __syncthreads();
  const float ah = av[h];
  for (int s = threadIdx.x; s < cs; s += kThreads)
    ddt[(t0 + s) * nh + h] = ((sm.colt[s] + sm.diagt[s]) + sm.dw[s] * sm.decay[s])
                             + sm.dcum[s] * ah;
}

// ------------------------------------------ pass 4: dG, summed over heads

constexpr int kThreadsG = 128;

struct SmemG {
  float dy[kTD][kLdX4];
  float x[kTD][kLdX4];
  float cum_l[kTD];
  float cum_s[kTD];
  float dt_s[kTD];
};
static_assert(sizeof(SmemG) == 35584, "ssd_bwd_dg_kernel: dynamic shared memory");

__global__ void __launch_bounds__(kThreadsG)
    ssd_bwd_dg_kernel(const float* __restrict__ dy, const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ cum, float* __restrict__ dg,
                      int nh, int p, int cs, int ntri, bool vec_x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemG& sm = *reinterpret_cast<SmemG*>(smem_raw);
  const int bc = blockIdx.x / ntri;            // b * nc + c
  const int tri = blockIdx.x - bc * ntri;      // tile (ti, tj), tj <= ti
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= tri) ++ti;
  const int tj = tri - ti * (ti + 1) / 2;
  const int l0 = ti * kTD;
  const int s0 = tj * kTD;
  const long long t0 = (long long)bc * cs;
  const long long xstep = (long long)nh * p;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp >> 1) * 32;             // rows l of the warp's tile
  const int wn = (warp & 1) * 32;              // columns s
  const bool on[2] = {true, true};
  float tot[2][4][4] = {};
  for (int h = 0; h < nh; ++h) {
    load_tile(&sm.dy[0][0], kLdX4, dy + (t0 + l0) * xstep + (long long)h * p,
              xstep, kTD, kMaxP, cs - l0, p, vec_x, dy);
    load_tile(&sm.x[0][0], kLdX4, x + (t0 + s0) * xstep + (long long)h * p, xstep,
              kTD, kMaxP, cs - s0, p, vec_x, x);
    cp_commit();
    const float* cum_h = cum + ((long long)bc * nh + h) * cs;
    for (int i = threadIdx.x; i < kTD; i += kThreadsG) {
      sm.cum_l[i] = l0 + i < cs ? cum_h[l0 + i] : 0.0f;
      sm.cum_s[i] = s0 + i < cs ? cum_h[s0 + i] : 0.0f;
      sm.dt_s[i] = s0 + i < cs ? dt[(t0 + s0 + i) * nh + h] : 0.0f;
    }
    cp_wait<0>();
    __syncthreads();
    float acc[2][4][4] = {};
    for (int k0 = 0; k0 < p; k0 += 8)
      mma_step(acc, on, 4, k0,
               [&](int mi, int r, int k) { return sm.dy[wm + 16 * mi + r][k]; },
               [&](int ni, int k, int c) { return sm.x[wn + 8 * ni + c][k]; }, g, t);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int li = wm + 16 * mi + g + 8 * half;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int si = wn + 8 * ni + 2 * t + j;
            // select, never multiply by the mask: exp overflows above it
            if (s0 + si <= l0 + li && l0 + li < cs)
              tot[mi][ni][2 * half + j] +=
                  acc[mi][ni][2 * half + j] *
                  (expf(sm.cum_l[li] - sm.cum_s[si]) * sm.dt_s[si]);
          }
      }
    __syncthreads();           // done with the tiles before they are loaded again
  }
  store_tile(dg + (long long)bc * cs * cs + (long long)l0 * cs + s0, cs, tot, wm, wn,
             cs - l0, cs - s0, g, t);
}

// ------------------------------- pass 5: dC and dB, summed over heads

struct SmemBC {
  union {
    struct {
      float a[kTD][kLdX4];                     // a head's rows of dy or x
      float st[kMaxP][kLdB2];                  // its S_in or dS
    } h;
    struct {
      float g[kTD][kLdK];                      // dG by rows l (dC)
      float gt[kKT][kLdX];                     // dG by rows l, read as dG^T (dB)
      float v[kKT][kLdB2];                     // rows of B (dC) or C (dB)
    } s;
  } u;
  float sc[kTD];                               // the rows' e or w
};
static_assert(sizeof(SmemBC) == 52480, "ssd_bwd_bc_kernel: dynamic shared memory");

__global__ void __launch_bounds__(kThreads)
    ssd_bwd_bc_kernel(const float* __restrict__ dy, const float* __restrict__ x,
                      const float* __restrict__ dt, const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ cum,
                      const float* __restrict__ states,
                      const float* __restrict__ dstates,
                      const float* __restrict__ dg, float* __restrict__ db,
                      float* __restrict__ dc, int nh, int p, int n, int cs,
                      int nrt, bool vec_x, bool vec_bc, bool vec_sc,
                      bool vec_st) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemBC& sm = *reinterpret_cast<SmemBC*>(smem_raw);
  const int which = blockIdx.x & 1;            // 0: dC, 1: dB
  const int rest = blockIdx.x >> 1;
  const int bc = rest / nrt;
  const int r0 = (rest - bc * nrt) * kTD;      // the block's rows l (dC) or s (dB)
  const long long t0 = (long long)bc * cs;
  const long long xstep = (long long)nh * p;
  const float* rows = which ? x : dy;
  const float* st = which ? dstates : states;
  const float* gsc = dg + (long long)bc * cs * cs;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp >> 2) * 32;             // rows of the warp's tile
  const int wn = (warp & 3) * 32;              // columns n
  const bool on[2] = {r0 + wm < cs, r0 + wm + 16 < cs};
  const int nn = wn < n ? min(4, (n - wn + 7) / 8) : 0;
  float acc[2][4][4] = {};
  // sum_h (e_h dy_h) S_in,h or (w_h x_h) dS_h: over (h, p)
  for (int h = 0; h < nh; ++h) {
    load_tile(&sm.u.h.a[0][0], kLdX4, rows + (t0 + r0) * xstep + (long long)h * p,
              xstep, kTD, kMaxP, cs - r0, p, vec_x, x);
    load_tile(&sm.u.h.st[0][0], kLdB2, st + ((long long)bc * nh + h) * p * n, n,
              kMaxP, kMaxN, p, n, vec_st, states);
    cp_commit();
    const float* cum_h = cum + ((long long)bc * nh + h) * cs;
    for (int i = threadIdx.x; i < kTD; i += kThreads) {
      const int r = r0 + i;
      sm.sc[i] = r >= cs ? 0.0f
                 : which ? expf(cum_h[cs - 1] - cum_h[r]) * dt[(t0 + r) * nh + h]
                         : expf(cum_h[r]);
    }
    cp_wait<0>();
    __syncthreads();
    for (int k0 = 0; k0 < p; k0 += 8)
      mma_step(acc, on, nn, k0,
               [&](int mi, int r, int k) {
                 const int row = wm + 16 * mi + r;
                 return sm.u.h.a[row][k] * sm.sc[row];
               },
               [&](int ni, int k, int c) { return sm.u.h.st[k][wn + 8 * ni + c]; },
               g, t);
    __syncthreads();
  }
  if (which == 0) {
    // dC += dG B over s <= l
    const int kmax = min(r0 + kTD, cs);
    for (int s0 = 0; s0 < kmax; s0 += kKT) {
      load_tile(&sm.u.s.g[0][0], kLdK, gsc + (long long)r0 * cs + s0, cs, kTD, kKT,
                cs - r0, cs - s0, vec_sc, dg);
      load_tile(&sm.u.s.v[0][0], kLdB2, bm + (t0 + s0) * n, n, kKT, kMaxN, cs - s0,
                n, vec_bc, bm);
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      const int kend = min(kKT, kmax - s0);
      for (int k0 = 0; k0 < kend; k0 += 8)
        mma_step(acc, on, nn, k0,
                 [&](int mi, int r, int k) { return sm.u.s.g[wm + 16 * mi + r][k]; },
                 [&](int ni, int k, int c) { return sm.u.s.v[k][wn + 8 * ni + c]; },
                 g, t);
      __syncthreads();
    }
  } else {
    // dB += dG^T C over l >= s
    for (int l0 = r0; l0 < cs; l0 += kKT) {
      load_tile(&sm.u.s.gt[0][0], kLdX, gsc + (long long)l0 * cs + r0, cs, kKT, kTD,
                cs - l0, cs - r0, vec_sc, dg);
      load_tile(&sm.u.s.v[0][0], kLdB2, cm + (t0 + l0) * n, n, kKT, kMaxN, cs - l0,
                n, vec_bc, cm);
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      const int kend = min(kKT, cs - l0);
      for (int k0 = 0; k0 < kend; k0 += 8)
        mma_step(acc, on, nn, k0,
                 [&](int mi, int r, int k) { return sm.u.s.gt[k][wm + 16 * mi + r]; },
                 [&](int ni, int k, int c) { return sm.u.s.v[k][wn + 8 * ni + c]; },
                 g, t);
      __syncthreads();
    }
  }
  store_tile((which ? db : dc) + (t0 + r0) * n, n, acc, wm, wn, cs - r0, n, g, t);
}

// ------------------------------------- pass 6: a's and D's gradients

__global__ void ssd_bwd_reduce_kernel(const float* __restrict__ parts,
                                      float* __restrict__ da,
                                      float* __restrict__ dd, int nh,
                                      long long nbc) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= nh) return;
  float sa = 0.0f, sd = 0.0f;
  for (long long i = 0; i < nbc; ++i) {        // batch rows and chunks in order
    sa += parts[i * nh + h];
    sd += parts[(nbc + i) * nh + h];
  }
  da[h] = sa;
  dd[h] = sd;
}

}  // namespace

// d_final may be null (zeros).  The forward's scratch: cum [B, nc, H, cs],
// states (entering each chunk) [B, nc, H, P, N], scores [B, nc, cs, cs].
// Outputs: dx [B, S, H, P], ddt [B, S, H], da [H], db and dc [B, S, N],
// dd [H], d_init [B, H, P, N].  Scratch: dstates [B, nc, H, P, N], dg [B,
// nc, cs, cs], parts [2, B, nc, H].  Six launches on the stream; returns
// the first error.
extern "C" int repro_ssd_scan_bwd(const float* dy, const float* d_final,
                                  const float* x, const float* dt,
                                  const float* a, const float* bm,
                                  const float* cm, const float* dskip,
                                  const float* cum, const float* states,
                                  const float* scores, float* dx, float* ddt,
                                  float* da, float* db, float* dc, float* dd,
                                  float* d_init, float* dstates, float* dg,
                                  float* parts, int b, int s, int nh, int p,
                                  int n, int cs, void* stream) {
  if (b <= 0 || s <= 0 || nh <= 0 || p <= 0 || p > kMaxP || n <= 0 ||
      n > kMaxN || cs <= 0 || cs > kMaxCS || s % cs != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nc = s / cs;
  const int nbc = b * nc;
  const int nt = (cs + kTD - 1) / kTD;
  const int ntri = nt * (nt + 1) / 2;
  const bool vec_x = p % 4 == 0 && aligned16(x) && aligned16(dy);
  const bool vec_bc = n % 4 == 0 && aligned16(bm) && aligned16(cm);
  const bool vec_sc = cs % 4 == 0 && aligned16(scores) && aligned16(dg);
  const bool vec_st = n % 4 == 0 && aligned16(states) && aligned16(dstates);
  cudaError_t err;
  if ((err = set_smem(ssd_bwd_dstate_kernel, sizeof(SmemD))) != cudaSuccess ||
      (err = set_smem(ssd_bwd_chunk_kernel, sizeof(Smem3))) != cudaSuccess ||
      (err = set_smem(ssd_bwd_dg_kernel, sizeof(SmemG))) != cudaSuccess ||
      (err = set_smem(ssd_bwd_bc_kernel, sizeof(SmemBC))) != cudaSuccess)
    return (int)err;
  ssd_bwd_dstate_kernel<<<nbc * nh, kThreads, sizeof(SmemD), st>>>(
      dy, cm, cum, dstates, nh, p, n, cs, vec_x, vec_bc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long count = (long long)b * nh * p * n;
  ssd_bwd_carry_kernel<<<(unsigned)((count + kThreads - 1) / kThreads), kThreads,
                         0, st>>>(dstates, cum, d_final, d_init, nc, nh, p * n, cs,
                                  count);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_chunk_kernel<<<nbc * nh, kThreads, sizeof(Smem3), st>>>(
      dy, x, dt, a, bm, cm, dskip, cum, states, dstates, scores, dx, ddt, parts,
      nh, p, n, cs, (long long)nbc * nh, vec_x, vec_bc, vec_sc, vec_st);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_dg_kernel<<<nbc * ntri, kThreadsG, sizeof(SmemG), st>>>(
      dy, x, dt, cum, dg, nh, p, cs, ntri, vec_x);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_bc_kernel<<<nbc * nt * 2, kThreads, sizeof(SmemBC), st>>>(
      dy, x, dt, bm, cm, cum, states, dstates, dg, db, dc, nh, p, n, cs, nt,
      vec_x, vec_bc, vec_sc, vec_st);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_reduce_kernel<<<(nh + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      parts, da, dd, nh, nbc);
  return (int)cudaGetLastError();
}
