// One-token decode attention over a ring-buffer KV cache.
//
// swa_decode_kernel replaces the Pallas TPU kernel swa_decode_tiled
// (_kernel) of src/repro/kernels/swa_decode/kernel.py.  For each batch row
// b and KV head h, with the G query heads of that KV head (q pre-scaled
// by dh^-0.5):
//   out[b, h, g] = sum_s softmax_s(q[b, h, g] . k[b, s, h]) v[b, s, h]
// over the slots s whose absolute position p = pos[s] is valid:
// 0 <= p <= qpos, and p > qpos - window when a window is set.  As in the
// TPU kernel, an invalid slot's score is -1e30 and its probability is
// forced to 0, and the output is acc / max(l, 1e-30).
//
// What bounds it on this card: device memory.  Each cached K and V value
// is read once and used for G multiply-adds (G = 4 for gemma3's MQA), far
// below the card's balance point: 2*B*W*Hkv*dh*4 bytes per call.
//
// Design (a simple first version): one block of 8 warps per (b, h).  The
// G query rows sit in shared memory.  The warps split the W slots, U at a
// time (the loads of those U rows of K and V are issued together, and the
// positions of the next U slots are read a step ahead), and each keeps
// its own running max m, normaliser l and [G, dh] accumulator in
// registers: lane L holds columns L, L+32, ... of every row, so each K/V
// row is read in coalesced 128-byte lines, and a warp's dot products end
// in a butterfly of shuffles that leaves the same sum on every lane.
// At the end the warps' partial states are merged in shared memory, warp
// by warp in a fixed order, so the result is the same from run to run.
// Slots whose position is invalid are not read.  Bounds checks replace
// the TPU kernel's kv_blk divisibility rule: any W works.  Template
// parameters fix the register arrays: DPL columns per lane (dh <= 32*DPL)
// and MAXG query rows (G <= MAXG); the launcher rounds both up to powers
// of two.
// Left for later: with gemma3's single KV head, a batch of B rows is only
// B blocks on 132 SMs; splitting W across blocks with a second combine
// pass (flash-decoding) would fill the card.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

template <int DPL, int MAXG>
__global__ void __launch_bounds__(kThreads)
    swa_decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const int* __restrict__ pos,
                      float* __restrict__ out, int w, int hkv, int g, int dh,
                      long long qpos, long long window) {
  constexpr int kCols = DPL * 32;
  constexpr int U = (MAXG * DPL > 32) ? 2 : 4;   // slots per warp step
  __shared__ float sq[MAXG][kCols];
  __shared__ float sacc[MAXG][kCols];
  __shared__ float sm[kWarps][MAXG];
  __shared__ float sl[kWarps][MAXG];
  __shared__ float s_norm[MAXG];

  const int bh = blockIdx.x;                    // b * hkv + h
  const int b = bh / hkv;
  const int h = bh - b * hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const float* qbh = q + (long long)bh * g * dh;
  for (int i = threadIdx.x; i < MAXG * kCols; i += kThreads) {
    const int gi = i / kCols;
    const int d = i - gi * kCols;
    sq[gi][d] = (gi < g && d < dh) ? qbh[gi * dh + d] : 0.0f;
  }
  __syncthreads();

  // the K/V row of slot s starts at ((b * w + s) * hkv + h) * dh
  const long long row_stride = (long long)hkv * dh;
  const float* kb = k + ((long long)b * w * hkv + h) * dh;
  const float* vb = v + ((long long)b * w * hkv + h) * dh;

  float m[MAXG], l[MAXG], acc[MAXG][DPL];
#pragma unroll
  for (int gi = 0; gi < MAXG; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.0f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[gi][j] = 0.0f;
  }

  // the positions of the warp's next U slots are read one step ahead, so
  // that the K/V loads do not wait on them (-1 past the end: invalid)
  int pnext[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int s = warp * U + u;
    pnext[u] = s < w ? pos[s] : -1;
  }
  for (int base = warp * U; base < w; base += kWarps * U) {
    bool ok[U];
    bool any = false;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long p = pnext[u];
      ok[u] = p >= 0 && p <= qpos && (window < 0 || p > qpos - window);
      any = any || ok[u];
      const int s = base + kWarps * U + u;
      pnext[u] = s < w ? pos[s] : -1;
    }
    // the same on every lane: a step with no valid slot changes nothing
    if (!any) continue;
    float kr[U][DPL], vr[U][DPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long off = (long long)(base + u) * row_stride;
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = lane + 32 * j;
        const bool load = ok[u] && d < dh;
        kr[u][j] = load ? kb[off + d] : 0.0f;
        vr[u][j] = load ? vb[off + d] : 0.0f;
      }
    }
    float sc[U][MAXG];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int gi = 0; gi < MAXG; ++gi) sc[u][gi] = 0.0f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
#pragma unroll
      for (int gi = 0; gi < MAXG; ++gi) {
        const float qv = sq[gi][lane + 32 * j];
#pragma unroll
        for (int u = 0; u < U; ++u) sc[u][gi] += qv * kr[u][j];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int gi = 0; gi < MAXG; ++gi)
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          sc[u][gi] += __shfl_xor_sync(0xffffffffu, sc[u][gi], o);

#pragma unroll
    for (int gi = 0; gi < MAXG; ++gi) {
      float mx = m[gi];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (ok[u]) mx = fmaxf(mx, sc[u][gi]);
      const float alpha = expf(m[gi] - mx);
      float p[U];
      float psum = 0.0f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = ok[u] ? expf(sc[u][gi] - mx) : 0.0f;
        psum += p[u];
      }
      l[gi] = l[gi] * alpha + psum;
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        float pv = 0.0f;
#pragma unroll
        for (int u = 0; u < U; ++u) pv += p[u] * vr[u][j];
        acc[gi][j] = acc[gi][j] * alpha + pv;
      }
      m[gi] = mx;
    }
  }

  // merge the warps' states: the block-wide max M, each warp's share
  // scaled by exp(m_w - M), summed warp by warp in order
  if (lane == 0) {
#pragma unroll
    for (int gi = 0; gi < MAXG; ++gi) {
      sm[warp][gi] = m[gi];
      sl[warp][gi] = l[gi];
    }
  }
  __syncthreads();
  float scale[MAXG];
#pragma unroll
  for (int gi = 0; gi < MAXG; ++gi) {
    float mx = sm[0][gi];
    for (int wi = 1; wi < kWarps; ++wi) mx = fmaxf(mx, sm[wi][gi]);
    scale[gi] = expf(m[gi] - mx);
    if (threadIdx.x == gi) {
      float norm = 0.0f;
      for (int wi = 0; wi < kWarps; ++wi)
        norm += sl[wi][gi] * expf(sm[wi][gi] - mx);
      s_norm[gi] = fmaxf(norm, 1e-30f);
    }
  }
  for (int wi = 0; wi < kWarps; ++wi) {
    if (warp == wi) {
#pragma unroll
      for (int gi = 0; gi < MAXG; ++gi)
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          const int d = lane + 32 * j;
          const float part = acc[gi][j] * scale[gi];
          sacc[gi][d] = wi == 0 ? part : sacc[gi][d] + part;
        }
    }
    __syncthreads();
  }
  float* obh = out + (long long)bh * g * dh;
  for (int i = threadIdx.x; i < g * dh; i += kThreads) {
    const int gi = i / dh;
    const int d = i - gi * dh;
    obh[i] = sacc[gi][d] / s_norm[gi];
  }
}

template <int DPL, int MAXG>
void launch_one(const float* q, const float* k, const float* v,
                const int* pos, float* out, int b, int w, int hkv, int g,
                int dh, long long qpos, long long window,
                cudaStream_t stream) {
  swa_decode_kernel<DPL, MAXG><<<b * hkv, kThreads, 0, stream>>>(
      q, k, v, pos, out, w, hkv, g, dh, qpos, window);
}

template <int DPL>
void launch_dpl(int maxg, const float* q, const float* k, const float* v,
                const int* pos, float* out, int b, int w, int hkv, int g,
                int dh, long long qpos, long long window,
                cudaStream_t stream) {
  switch (maxg) {
    case 1: launch_one<DPL, 1>(q, k, v, pos, out, b, w, hkv, g, dh, qpos, window, stream); break;
    case 2: launch_one<DPL, 2>(q, k, v, pos, out, b, w, hkv, g, dh, qpos, window, stream); break;
    case 4: launch_one<DPL, 4>(q, k, v, pos, out, b, w, hkv, g, dh, qpos, window, stream); break;
    default: launch_one<DPL, 8>(q, k, v, pos, out, b, w, hkv, g, dh, qpos, window, stream); break;
  }
}

int round_up_pow2(int x) { return x <= 1 ? 1 : x <= 2 ? 2 : x <= 4 ? 4 : 8; }

}  // namespace

// window < 0: no window.  G <= 8 and dh <= 256.
extern "C" int repro_swa_decode(const float* q, const float* k,
                                const float* v, const int* pos, float* out,
                                int b, int w, int hkv, int g, int dh,
                                long long qpos, long long window,
                                void* stream) {
  if (b <= 0 || w <= 0 || hkv <= 0 || g <= 0 || g > 8 || dh <= 0 || dh > 256)
    return (int)cudaErrorInvalidValue;
  const int dpl = round_up_pow2((dh + 31) / 32);
  const int maxg = round_up_pow2(g);
  cudaStream_t s = (cudaStream_t)stream;
  switch (dpl) {
    case 1: launch_dpl<1>(maxg, q, k, v, pos, out, b, w, hkv, g, dh, qpos, window, s); break;
    case 2: launch_dpl<2>(maxg, q, k, v, pos, out, b, w, hkv, g, dh, qpos, window, s); break;
    case 4: launch_dpl<4>(maxg, q, k, v, pos, out, b, w, hkv, g, dh, qpos, window, s); break;
    default: launch_dpl<8>(maxg, q, k, v, pos, out, b, w, hkv, g, dh, qpos, window, s); break;
  }
  return (int)cudaGetLastError();
}
