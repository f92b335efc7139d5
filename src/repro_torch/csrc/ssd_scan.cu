// Mamba2 SSD chunked scan.
//
// ssd_scan_kernel replaces the Pallas TPU kernel ssd_scan_tiled (_kernel)
// of src/repro/kernels/ssd_scan/kernel.py.  For each batch row b and head
// h it walks the sequence chunk by chunk, carrying the float32 state
// S [P, N] on chip.  For a chunk of cs steps, with cum the inclusive
// cumulative sum of dt * a over the chunk and total = cum[cs - 1]:
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
// is about 90 operations per byte, above the card's 20 (67 TFLOP/s of
// float32 over 3.35 TB/s).
//
// Design (a simple first version, no tensor cores): one block of 8 warps
// per (b, h, 32 columns of P), so that mamba2-780m's 48 heads at B = 1
// give 96 blocks on 132 SMs; the columns of P are independent, since
// y[:, p] needs only S[p, :] and x[:, p].  The price is that every block
// recomputes C . B^T for its chunk.  The chunk does not fit in shared
// memory at cs = 256, N = 128 (B and C alone are 256 KB), so C and B are
// walked in tiles of 64 rows: for each tile of C (rows l), the inter term
// first, from S_in; then for each tile of B (rows s <= l) the 64 x 64
// scores, masked and decayed into shared memory, and their product with
// x.  The last tile of C meets every tile of B, so the state update rides
// along with it, in registers, and S_in stays intact in shared memory
// until the chunk is done.  Above the diagonal the exponent
// cum[l] - cum[s] is positive and may overflow: the entry is selected to
// 0, never multiplied by a mask, and exp is never split into
// exp(cum[l]) exp(-cum[s]).  Products use fmaf (the build's --fmad=false
// forbids only implicit contraction); exp is the accurate expf.  Bounds
// checks give any P <= 64, N <= 128 and cs <= 256.
// Left for later: wgmma for the three products, one C . B^T per (batch
// row, chunk) shared by the heads, and chunks in parallel (a chunk-state
// pass, a scan over chunks, then the outputs).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;          // rows of C (l) and of B (s) per tile
constexpr int kPT = 32;            // columns of P per block (one per lane)
constexpr int kMaxN = 128;
constexpr int kMaxCS = 256;
constexpr int kLdN = kMaxN + 1;    // padded rows: column reads hit 32 banks
constexpr int kLdT = kTile + 1;
constexpr int kYRows = kTile / kWarps;      // y rows per thread in a tile
constexpr int kSRows = kThreads / kMaxN;    // state rows covered per pass
constexpr int kSPer = kPT / kSRows;         // state entries per thread

struct Smem {
  float cum[kMaxCS];        // inclusive cumsum of dt * a over the chunk
  float dt[kMaxCS];
  float w[kMaxCS];          // exp(total - cum[s]) * dt[s]
  float x[kMaxCS][kPT];     // the chunk's x, this block's columns
  float c[kTile][kLdN];
  float b[kTile][kLdN];
  float m[kTile][kLdT];     // masked, decayed scores of one tile pair
  float st[kPT][kLdN];      // the state entering the chunk
};

__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const float* __restrict__ bm,
                    const float* __restrict__ cm,
                    const float* __restrict__ dskip,
                    const float* __restrict__ init, float* __restrict__ y,
                    float* __restrict__ final_state, int seq, int nh, int p,
                    int n, int cs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int bh = blockIdx.x;                   // b * nh + h
  const int b = bh / nh;
  const int h = bh - b * nh;
  const int p0 = blockIdx.y * kPT;
  const int pw = min(kPT, p - p0);             // this block's columns
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float ah = a[h];
  const float dh = dskip[h];

  // x and y: step t of row b at ((b * seq + t) * nh + h) * p + p0
  const long long step = (long long)nh * p;
  const float* xb = x + (long long)b * seq * step + (long long)h * p + p0;
  float* yb = y + (long long)b * seq * step + (long long)h * p + p0;
  const float* dtb = dt + (long long)b * seq * nh + h;
  const float* bb = bm + (long long)b * seq * n;
  const float* cb = cm + (long long)b * seq * n;
  const long long st_off = ((long long)bh * p + p0) * n;

  // thread tid owns state entries (sp0 + kSRows k, sn)
  const int sn = tid % kMaxN;
  const int sp0 = tid / kMaxN;
  for (int k = 0; k < kSPer; ++k) {
    const int pp = sp0 + kSRows * k;
    sm.st[pp][sn] = (init != nullptr && pp < pw && sn < n)
                        ? init[st_off + (long long)pp * n + sn]
                        : 0.0f;
  }

  const int nchunks = seq / cs;
  const int ntiles = (cs + kTile - 1) / kTile;
  const int ty = tid / 16;      // scores: rows ty + 16 i, columns tx + 16 j
  const int tx = tid % 16;

  for (int c = 0; c < nchunks; ++c) {
    const long long t0 = (long long)c * cs;
    __syncthreads();            // the previous chunk is done with every buffer
    for (int i = tid; i < kMaxCS; i += kThreads)
      sm.dt[i] = i < cs ? dtb[(t0 + i) * nh] : 0.0f;
    for (int i = tid; i < kMaxCS * kPT; i += kThreads) {
      const int r = i / kPT;
      const int col = i - r * kPT;
      sm.x[r][col] = (r < cs && col < pw) ? xb[(t0 + r) * step + col] : 0.0f;
    }
    __syncthreads();
    if (tid == 0) {
      // the inclusive cumsum in order, one rounded product and one rounded
      // sum per step, as the plain version's cumsum: cum[l] - cum[s] loses
      // digits to cancellation when |cum| is large, and the kernel and the
      // plain version then lose the same ones
      float run = 0.0f;
      for (int i = 0; i < kMaxCS; ++i) {
        if (i < cs) run += sm.dt[i] * ah;
        sm.cum[i] = run;
      }
    }
    __syncthreads();
    const float total = sm.cum[cs - 1];
    for (int i = tid; i < kMaxCS; i += kThreads)
      sm.w[i] = i < cs ? expf(total - sm.cum[i]) * sm.dt[i] : 0.0f;

    float sacc[kSPer];          // S_out, built during the last tile of C
    for (int it = 0; it < ntiles; ++it) {
      const int l0 = it * kTile;
      const bool last = it == ntiles - 1;
      __syncthreads();          // done with the previous tile of C (and w set)
      for (int i = tid; i < kTile * kMaxN; i += kThreads) {
        const int r = i / kMaxN;
        const int col = i - r * kMaxN;
        sm.c[r][col] = (l0 + r < cs && col < n)
                           ? cb[(t0 + l0 + r) * n + col] : 0.0f;
      }
      __syncthreads();

      // inter-chunk term and skip: exp(cum[l]) (C[l] . S_in[q]) + D x[l, q]
      // for rows l = l0 + warp + kWarps r and column q = lane
      float yacc[kYRows];
#pragma unroll
      for (int r = 0; r < kYRows; ++r) yacc[r] = 0.0f;
      for (int k = 0; k < n; ++k) {
        const float s_k = sm.st[lane][k];
#pragma unroll
        for (int r = 0; r < kYRows; ++r)
          yacc[r] = fmaf(sm.c[warp + kWarps * r][k], s_k, yacc[r]);
      }
#pragma unroll
      for (int r = 0; r < kYRows; ++r) {
        const int l = l0 + warp + kWarps * r;
        yacc[r] = fmaf(yacc[r], expf(sm.cum[l]), dh * sm.x[l][lane]);
      }
      if (last) {
        const float decay = expf(total);
#pragma unroll
        for (int k = 0; k < kSPer; ++k)
          sacc[k] = decay * sm.st[sp0 + kSRows * k][sn];
      }

      for (int jt = 0; jt <= it; ++jt) {
        const int s0 = jt * kTile;
        __syncthreads();        // done with the previous tiles of B and scores
        for (int i = tid; i < kTile * kMaxN; i += kThreads) {
          const int r = i / kMaxN;
          const int col = i - r * kMaxN;
          sm.b[r][col] = (s0 + r < cs && col < n)
                             ? bb[(t0 + s0 + r) * n + col] : 0.0f;
        }
        __syncthreads();
        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
        for (int k = 0; k < n; ++k) {
          float cr[4], br[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cr[i] = sm.c[ty + 16 * i][k];
#pragma unroll
          for (int j = 0; j < 4; ++j) br[j] = sm.b[tx + 16 * j][k];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(cr[i], br[j], sc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int l = l0 + ty + 16 * i;
            const int s = s0 + tx + 16 * j;
            // select, never multiply by the mask: exp overflows above it
            sm.m[ty + 16 * i][tx + 16 * j] =
                (s <= l && l < cs)
                    ? sc[i][j] * expf(sm.cum[l] - sm.cum[s]) * sm.dt[s]
                    : 0.0f;
          }
        __syncthreads();
        for (int s = 0; s < kTile; ++s) {
          const float xv = sm.x[s0 + s][lane];
#pragma unroll
          for (int r = 0; r < kYRows; ++r)
            yacc[r] = fmaf(sm.m[warp + kWarps * r][s], xv, yacc[r]);
        }
        if (last) {
          for (int s = 0; s < kTile; ++s) {
            const float bw = sm.b[s][sn] * sm.w[s0 + s];
#pragma unroll
            for (int k = 0; k < kSPer; ++k)
              sacc[k] = fmaf(sm.x[s0 + s][sp0 + kSRows * k], bw, sacc[k]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kYRows; ++r) {
        const int l = l0 + warp + kWarps * r;
        if (l < cs && lane < pw) yb[(t0 + l) * step + lane] = yacc[r];
      }
    }
    __syncthreads();            // every read of S_in is done
#pragma unroll
    for (int k = 0; k < kSPer; ++k) sm.st[sp0 + kSRows * k][sn] = sacc[k];
  }
  for (int k = 0; k < kSPer; ++k) {
    const int pp = sp0 + kSRows * k;
    if (pp < pw && sn < n) final_state[st_off + (long long)pp * n + sn] = sm.st[pp][sn];
  }
}

}  // namespace

// init may be null (a zero initial state).  P <= 64, N <= 128, chunk <= 256
// and S % chunk == 0.
extern "C" int repro_ssd_scan(const float* x, const float* dt, const float* a,
                              const float* bm, const float* cm,
                              const float* dskip, const float* init, float* y,
                              float* final_state, int b, int s, int nh, int p,
                              int n, int cs, void* stream) {
  if (b <= 0 || s <= 0 || nh <= 0 || p <= 0 || p > 2 * kPT || n <= 0 ||
      n > kMaxN || cs <= 0 || cs > kMaxCS || s % cs != 0)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b * nh, (p + kPT - 1) / kPT);
  ssd_scan_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, dt, a, bm, cm, dskip, init, y, final_state, s, nh, p, n, cs);
  return (int)cudaGetLastError();
}
